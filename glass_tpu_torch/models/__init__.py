from .glass_rcnn import (
    GlassArch,
    GlassRCNN,
    emit_mask,
    emit_text,
    glass_inference_single,
)
