"""``sequence_mask`` (counterpart of ``paddle_tpu/layers/sequence_lod.py:139``).
The LoD sequence layers come with a later slice (ROADMAP.md)."""
from __future__ import annotations

from ..core import dtypes as _dt
from ..layer_helper import LayerHelper

__all__ = ["sequence_mask"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", input=x, name=name)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("sequence_mask", inputs={"X": [x]}, outputs={"Y": [out]},
                     attrs={"maxlen": maxlen if maxlen is not None else -1,
                            "out_dtype": _dt.dtype_to_enum(dtype)})
    return out
