"""Device residency/staging helpers shared by the serving predictors.

Params stay device-resident across volumes (one device_put per
checkpoint, not per case — per-call staging of the full param tree
would repeat a host-to-device copy of every weight per volume). One
implementation so the cache-key and bf16-staging contracts cannot drift
between the sliding-window and spatial predictors.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import numpy as np


def normalize_tta_mode(tta: Union[bool, str, None]) -> Optional[str]:
    """Normalize a predictor's ``tta`` argument to None | "permute" | "flips".

    One implementation for both serving predictors (sliding-window and
    spatial/direct) so the accepted spellings — and the error text — cannot
    drift between the two duck-typed surfaces: False/None → no TTA, True →
    "permute" (the reference's ``predict(permute=True)`` 48-symmetry
    average), strings pass through validated."""
    mode = tta if isinstance(tta, str) else ("permute" if tta else None)
    if mode not in (None, "permute", "flips"):
        raise ValueError(f"unknown TTA mode {mode!r} "
                         "(expected 'permute' or 'flips')")
    return mode


def is_fp16_transfer(transfer_dtype) -> bool:
    """True when a ``transfer_dtype`` argument asks for the fp16-packed D2H
    path (halves probability-map transfer bytes; max quantization ~4.9e-4 on
    [0,1]). Shared so both predictors accept the same spellings."""
    return str(transfer_dtype) in ("float16", "fp16", "half")


# probability-transfer quantization scales: probabilities live in [0,1], so
# a fixed-point integer transfer is exact to 0.5/scale — uint8 cuts the D2H
# bytes 4x vs fp32 (max err 2.0e-3), uint16 2x (7.6e-6). The written NIfTI
# stays float32 (dequantized host-side); opt-in via --prob-dtype.
_QUANT_SCALE = {"uint8": 255.0, "uint16": 65535.0}


def resolve_prob_transfer(transfer_dtype) -> str:
    """Canonicalize a probability ``transfer_dtype`` to one of
    "float32" | "float16" | "uint8" | "uint16" (shared by both serving
    predictors so spellings and the error text cannot drift)."""
    s = str(transfer_dtype)
    if s in ("float32", "fp32", "single", "None"):
        return "float32"
    if is_fp16_transfer(s):
        return "float16"
    if s in ("uint8", "u8"):
        return "uint8"
    if s in ("uint16", "u16"):
        return "uint16"
    raise ValueError(f"unknown probability transfer dtype {transfer_dtype!r}"
                     " (expected float32, float16, uint8 or uint16)")


def quantize_prob(prob, kind: str):
    """In-program fixed-point quantization of a [0,1] probability map —
    only the integer volume crosses the D2H link."""
    import jax.numpy as jnp

    scale = _QUANT_SCALE[kind]
    return jnp.round(jnp.clip(prob, 0.0, 1.0) * scale).astype(
        jnp.uint8 if kind == "uint8" else jnp.uint16)


def unpack_prob_f32(out) -> np.ndarray:
    """Materialize an async probability result as float32 (L, D, H, W),
    dequantizing fixed-point transfers by their dtype's scale.

    ``copy=False``: on the default fp32 path the D2H array is already
    float32 — a second full-volume copy here would double host memory
    traffic for nothing; fp16/integer results still convert."""
    arr = np.asarray(out)
    scale = _QUANT_SCALE.get(str(arr.dtype))
    if scale is not None:
        return arr.astype(np.float32) / np.float32(scale)
    return arr.astype(np.float32, copy=False)


def host_round_for_model(arr, model):
    """Round a host fp32 volume to bf16 iff the model computes in bf16.

    Halves the H2D bytes with BIT-IDENTICAL results: the model's first op
    casts its input to bf16 anyway, and pad/transpose/gather between the
    upload and that cast preserve values exactly. Keyed on the MODEL's
    compute dtype (not the config) — only a model that actually casts
    makes the rounding a no-op."""
    import jax.numpy as jnp

    if getattr(model, "dtype", None) == jnp.bfloat16:
        import ml_dtypes

        return arr.astype(ml_dtypes.bfloat16)
    return arr


class ResidentParamsMixin:
    """Mixin providing ``device_variables`` with a leaf-identity cache.

    Keyed on the identity of every LEAF (not the container), so both a new
    dict and an in-place swap like ``variables["params"] = new`` invalidate
    the cache — a container-identity key would silently keep serving the
    previously uploaded weights. Subclasses may set ``_resident_sharding``
    (e.g. a replicated NamedSharding) to control placement.
    """

    _resident_key = None
    _resident_host = None
    _resident_vars = None
    _resident_sharding = None

    def device_variables(self, variables):
        key = tuple(id(l) for l in jax.tree_util.tree_leaves(variables))
        if self._resident_key != key:
            self._resident_key = key
            # keep a strong ref to the host tree while cached: otherwise a
            # GC'd leaf could hand its id() to a new array (false cache hit)
            self._resident_host = variables
            self._resident_vars = (
                jax.device_put(variables, self._resident_sharding)
                if self._resident_sharding is not None
                else jax.device_put(variables))
        return self._resident_vars
