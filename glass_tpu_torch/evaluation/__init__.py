"""The RRC text-spotting evaluator: the port's own copy of
``glass_tpu/evaluation`` (no JAX, no ``python-Levenshtein``)."""

from .text_eval import (
    EvalInstance,
    evaluate_image,
    evaluate_dataset,
    transcription_match,
    include_in_dictionary,
)
from .evaluator import TextEvaluator, instances_to_eval, load_gt_zip
from .rrc_validation import (
    load_zip_file,
    validate_lines_in_file,
    validate_lines_in_file_gt,
    validate_submission,
)
from .lexicon import (
    Lexicon,
    LexiconSet,
    edit_distance,
    find_match_word,
    match_transcript,
    weighted_edit_distance,
)
