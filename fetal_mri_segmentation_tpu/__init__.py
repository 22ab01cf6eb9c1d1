"""fetal_mri_segmentation_tpu — a JAX/XLA framework for 3D
fetal-MRI segmentation with the full capabilities of
GalDude33/Fetal-MRI-Segmentation (Keras 3D U-Net lineage, ellisdg/3DUnetCNN).

This is a from-scratch accelerator-first design, not a port:

- one pure-functional core (``init / train_step / predict_volume`` as jitted
  functions over pytrees), RNG as explicit ``jax.random`` keys;
- data augmentation (flip / 48-symmetry permute / contrast / scale-distort)
  runs on-device inside the jitted train step, replacing the reference's
  host-side nilearn affine-resample generator (reference:
  unet3d/augment.py::augment_data);
- sliding-window inference with Gaussian overlap-add reconstruction is a
  single on-device ``lax.scan`` (reference: unet3d/prediction.py::
  patch_wise_prediction + unet3d/utils/patches.py::reconstruct_from_patches);
- multi-device training is data-parallel over a ``jax.sharding.Mesh`` with
  a gradient psum (NCCL over NVLink between GPUs; net-new, the reference
  is single-device).

Public surface kept from the reference: train/predict/evaluate entry points,
the HDF5 dataset contract (``data``/``truth``/``affine`` arrays), split
pickles, per-case ``prediction.nii.gz`` outputs and Dice CSV reporting, and
the config key names (SURVEY.md section 5.6).
"""

__version__ = "0.1.0"

from fetal_mri_segmentation_tpu.config import Config  # noqa: F401
