from .glass_rcnn import (
    GlassArch,
    GlassRCNN,
    emit_mask,
    emit_text,
    glass_detect_stage,
    glass_heads_stage,
    glass_inference_single,
)
