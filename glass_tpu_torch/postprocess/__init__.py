from .post_processor import (
    PostProcessorRotatedBoxes,
    PostProcessorAcademic,
    build_post_processor,
    detector_postprocess,
)
