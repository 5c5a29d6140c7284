"""Default configuration schema (a copy of the glass_tpu schema, so that the
port reads the same YAML files and opts).

This schema is a superset of the keys consumed by the reference stack so that
released GLASS YAML configs (reference ``configs/glass_pretrain.yaml`` and
``configs/glass_finetune_*.yaml``) parse verbatim.  It merges three sources:

* the detectron2 default tree (the subset the GLASS configs reference),
* the GLASS additions declared in reference ``glass/config.py:10-226``
  (``add_dataset_config`` / ``add_glass_config`` / ``add_e2e_config`` /
  ``add_post_process_config``),
* TPU-specific execution knobs under ``TPU.*`` (static padding sizes and
  sharding), which have no reference counterpart because detectron2 relies on
  dynamic shapes.

The default *values* follow the reference defaults so that an empty override
file reproduces reference behaviour.
"""

from .node import CfgNode as CN

# The 95-char printable charset used by the released configs (vocab = 97 with
# the [GO]/[s] tokens).  Note the reference Python default collapses the
# escaped quote (reference ``glass/config.py:138``) yielding 94 chars; released
# checkpoints follow the YAML value, which we replicate here.
CHARACTER_SET = (
    "0123456789abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~ "
)


def get_default_config() -> CN:
    _C = CN()

    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    _C.SEED = -1
    _C.CUDNN_BENCHMARK = False
    _C.VIS_PERIOD = 0

    _C.GLOBAL = CN()
    _C.GLOBAL.HACK = 1.0

    # ------------------------------------------------------------------ MODEL
    _C.MODEL = CN()
    _C.MODEL.DEVICE = "tpu"
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.LOAD_PROPOSALS = False
    _C.MODEL.PIXEL_MEAN = [103.53, 116.28, 123.675]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
    # GLASS flags (reference glass/config.py:25-26,83-91)
    _C.MODEL.ROTATED_BOXES_ON = False
    _C.MODEL.ORIENTATION_ON = False
    _C.MODEL.RECOGNIZER_ON = False

    _C.MODEL.BACKBONE = CN()
    _C.MODEL.BACKBONE.NAME = "build_resnet_fpn_backbone"
    _C.MODEL.BACKBONE.FREEZE_AT = 2

    _C.MODEL.FPN = CN()
    _C.MODEL.FPN.IN_FEATURES = []
    _C.MODEL.FPN.OUT_CHANNELS = 256
    _C.MODEL.FPN.NORM = ""
    _C.MODEL.FPN.FUSE_TYPE = "sum"

    _C.MODEL.RESNETS = CN()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.RES5_DILATION = 1
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
    _C.MODEL.RESNETS.DEFORM_MODULATED = False
    _C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1

    _C.MODEL.ANCHOR_GENERATOR = CN()
    _C.MODEL.ANCHOR_GENERATOR.NAME = "DefaultAnchorGenerator"
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    _C.MODEL.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]
    _C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    _C.MODEL.PROPOSAL_GENERATOR = CN()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

    _C.MODEL.RPN = CN()
    _C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
    _C.MODEL.RPN.IN_FEATURES = ["res4"]
    _C.MODEL.RPN.BOUNDARY_THRESH = -1
    _C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
    _C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    _C.MODEL.RPN.POSITIVE_FRACTION = 0.5
    _C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.BBOX_REG_WEIGHTS = [1.0, 1.0, 1.0, 1.0, 1.0]
    _C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    _C.MODEL.RPN.LOSS_WEIGHT = 1.0
    _C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
    _C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
    _C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
    _C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    _C.MODEL.RPN.NMS_THRESH = 0.7
    _C.MODEL.RPN.CONV_DIMS = [-1]

    _C.MODEL.ROI_HEADS = CN()
    _C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 80
    _C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
    _C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    _C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    _C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True
    _C.MODEL.ROI_HEADS.CLASS_NAMES = ["word"]

    _C.MODEL.ROI_BOX_HEAD = CN()
    _C.MODEL.ROI_BOX_HEAD.NAME = ""
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = [10.0, 10.0, 5.0, 5.0]
    _C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
    _C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    _C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_BOX_HEAD.NORM = ""
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    _C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False

    _C.MODEL.ROI_BOX_CASCADE_HEAD = CN()
    _C.MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS = [
        [10.0, 10.0, 5.0, 5.0],
        [20.0, 20.0, 10.0, 10.0],
        [30.0, 30.0, 15.0, 15.0],
    ]
    _C.MODEL.ROI_BOX_CASCADE_HEAD.IOUS = [0.5, 0.6, 0.7]

    # Mask head — doubles as the legacy recognizer config tree
    # (reference glass/config.py:84-123 "config duplication").
    _C.MODEL.ROI_MASK_HEAD = CN()
    _C.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
    _C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_MASK_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_MASK_HEAD.NORM = ""
    _C.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False
    _C.MODEL.ROI_MASK_HEAD.POOLER_TYPE = "ROIAlignV2"
    _C.MODEL.ROI_MASK_HEAD.LOSS_WEIGHT = 0.005
    _C.MODEL.ROI_MASK_HEAD.MASK_INFERENCE = False
    _C.MODEL.ROI_MASK_HEAD.SAMPLE_WORDS_STRATEGY = "random"
    _C.MODEL.ROI_MASK_HEAD.SAMPLE_WORDS_STRATEGY_PROB = 0.3
    _C.MODEL.ROI_MASK_HEAD.CLASS_IND = 0
    _C.MODEL.ROI_MASK_HEAD.IGNORE_EMPTY_TEXT = True
    _C.MODEL.ROI_MASK_HEAD.LABELS_TYPE = "attention"
    _C.MODEL.ROI_MASK_HEAD.MAX_WORD_LENGTH = 50
    _C.MODEL.ROI_MASK_HEAD.CHARACTER_SET = CHARACTER_SET
    _C.MODEL.ROI_MASK_HEAD.UNK_SYMBOL_PRED = False
    _C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION_WIDTH = 32
    _C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION_HEIGHT = 32
    _C.MODEL.ROI_MASK_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    _C.MODEL.ROI_MASK_HEAD.PAD_SAMPLER = ""
    _C.MODEL.ROI_MASK_HEAD.MAX_BATCH_SIZE = 256
    _C.MODEL.ROI_MASK_HEAD.IGNORE_TEXT = ["###"]
    _C.MODEL.ROI_MASK_HEAD.SENSITIVE = True
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD = CN()
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.POOLER_PAD = CN()
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.POOLER_PAD.NAME = ""
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.BACKBONE = CN()
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.BACKBONE.NAME = "CNN_V1"
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.ENCODER = CN()
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.ENCODER.NAME = "BiLSTMBlock"
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.ENCODER.NUM_OF_LAYERS = 2
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.ENCODER.HEIGHT_REDUCTION = "mean"
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.ENCODER.N_HEAD = 8
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.DECODER = CN()
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.DECODER.NAME = "ASTER"
    _C.MODEL.ROI_MASK_HEAD.RECOGNIZER_HEAD.DECODER.POS_ENC_HEIGHT_WIDTH = None

    # Current recognizer config tree (reference glass/config.py:126-168)
    _C.MODEL.ROI_RECOGNIZER_HEAD = CN()
    _C.MODEL.ROI_RECOGNIZER_HEAD.NAME = ""
    _C.MODEL.ROI_RECOGNIZER_HEAD.SAMPLE_WORDS_STRATEGY = "random"
    _C.MODEL.ROI_RECOGNIZER_HEAD.SAMPLE_WORDS_STRATEGY_PROB = 0.3
    _C.MODEL.ROI_RECOGNIZER_HEAD.LABELS_TYPE = "attention"
    _C.MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH = 50
    _C.MODEL.ROI_RECOGNIZER_HEAD.CHARACTER_SET = CHARACTER_SET
    _C.MODEL.ROI_RECOGNIZER_HEAD.UNK_SYMBOL_PRED = False
    _C.MODEL.ROI_RECOGNIZER_HEAD.IGNORE_EMPTY_TEXT = True
    _C.MODEL.ROI_RECOGNIZER_HEAD.POOLER_RESOLUTION_WIDTH = 32
    _C.MODEL.ROI_RECOGNIZER_HEAD.POOLER_RESOLUTION_HEIGHT = 32
    _C.MODEL.ROI_RECOGNIZER_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    _C.MODEL.ROI_RECOGNIZER_HEAD.CLASS_IND = 0
    _C.MODEL.ROI_RECOGNIZER_HEAD.PAD_SAMPLER = ""
    _C.MODEL.ROI_RECOGNIZER_HEAD.MAX_BATCH_SIZE = 256
    _C.MODEL.ROI_RECOGNIZER_HEAD.LOSS_WEIGHT = 2.0
    _C.MODEL.ROI_RECOGNIZER_HEAD.IGNORE_TEXT = ["###"]
    _C.MODEL.ROI_RECOGNIZER_HEAD.SENSITIVE = True
    _C.MODEL.ROI_RECOGNIZER_HEAD.POOLER_TYPE = "ROIAlignRotated"
    _C.MODEL.ROI_RECOGNIZER_HEAD.NORM = "BN"
    _C.MODEL.ROI_RECOGNIZER_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_RECOGNIZER_HEAD.SAMPLING_RATIO = 0
    _C.MODEL.ROI_RECOGNIZER_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD = CN()
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.POOLER_PAD = CN()
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.POOLER_PAD.NAME = ""
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.BACKBONE = CN()
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.BACKBONE.NAME = "CNN_V1_2"
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.ENCODER = CN()
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.ENCODER.NAME = "BiLSTMBlockV2"
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.ENCODER.NUM_OF_LAYERS = 2
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.ENCODER.HEIGHT_REDUCTION = "mean"
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.ENCODER.N_HEAD = 8
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.DECODER = CN()
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.DECODER.NAME = "ASTER_V2"
    _C.MODEL.ROI_RECOGNIZER_HEAD.RECOGNIZER_HEAD.DECODER.POS_ENC_HEIGHT_WIDTH = None

    _C.MODEL.ROI_ORIENTATION_HEAD = CN()
    _C.MODEL.ROI_ORIENTATION_HEAD.LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_ORIENTATION_HEAD.APPLY_TO_BOXES = False
    _C.MODEL.ROI_ORIENTATION_HEAD.APPLY_TO_BOXES_DURING_TRAINING = True

    _C.MODEL.ROI_HYBRID_HEAD = CN()
    _C.MODEL.ROI_HYBRID_HEAD.NAME = "ResBlockHybridHead"
    _C.MODEL.ROI_HYBRID_HEAD.POOLER_RESOLUTION = 64
    _C.MODEL.ROI_HYBRID_HEAD.NUM_FEATURES = 256
    _C.MODEL.ROI_HYBRID_HEAD.DEPTH = 3
    _C.MODEL.ROI_HYBRID_HEAD.NORM_IMG_CROPS = False

    _C.MODEL.FILTERED_RPN = CN()
    _C.MODEL.FILTERED_RPN.IGNORE_TEXT = ["###", ""]

    _C.MODEL.LOCAL_FEATURE_EXTRACTOR = CN()
    _C.MODEL.LOCAL_FEATURE_EXTRACTOR.NAME = "ResNetFeatureExtractor"
    _C.MODEL.LOCAL_FEATURE_EXTRACTOR.NUM_FEATURES = 256

    _C.MODEL.HYBRID_FUSION = CN()
    _C.MODEL.HYBRID_FUSION.NAME = "MultiAspectGCAttention"
    _C.MODEL.HYBRID_FUSION.NUM_FEATURES = 256
    _C.MODEL.HYBRID_FUSION.RATIO = 0.5
    _C.MODEL.HYBRID_FUSION.HEADERS = 8
    _C.MODEL.HYBRID_FUSION.FUSION_TYPE = "channel_add"

    _C.MODEL.ROI_KEYPOINT_HEAD = CN()
    _C.MODEL.ROI_KEYPOINT_HEAD.NAME = "KRCNNConvDeconvUpsampleHead"
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = [512] * 8
    _C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
    _C.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE = 1
    _C.MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS = True
    _C.MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE = "ROIAlignV2"

    _C.MODEL.RETINANET = CN()
    _C.MODEL.RETINANET.NUM_CLASSES = 80
    _C.MODEL.RETINANET.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    _C.MODEL.RETINANET.NUM_CONVS = 4
    _C.MODEL.RETINANET.IOU_THRESHOLDS = [0.4, 0.5]
    _C.MODEL.RETINANET.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RETINANET.PRIOR_PROB = 0.01
    _C.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
    _C.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 1000
    _C.MODEL.RETINANET.NMS_THRESH_TEST = 0.5
    _C.MODEL.RETINANET.BBOX_REG_WEIGHTS = [1.0, 1.0, 1.0, 1.0]
    _C.MODEL.RETINANET.FOCAL_LOSS_GAMMA = 2.0
    _C.MODEL.RETINANET.FOCAL_LOSS_ALPHA = 0.25
    _C.MODEL.RETINANET.SMOOTH_L1_LOSS_BETA = 0.1
    _C.MODEL.RETINANET.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.RETINANET.NORM = ""

    _C.MODEL.PANOPTIC_FPN = CN()
    _C.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT = 1.0
    _C.MODEL.PANOPTIC_FPN.COMBINE = CN()
    _C.MODEL.PANOPTIC_FPN.COMBINE.ENABLED = True
    _C.MODEL.PANOPTIC_FPN.COMBINE.OVERLAP_THRESH = 0.5
    _C.MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT = 4096
    _C.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.5

    _C.MODEL.SEM_SEG_HEAD = CN()
    _C.MODEL.SEM_SEG_HEAD.NAME = "SemSegFPNHead"
    _C.MODEL.SEM_SEG_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    _C.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = 255
    _C.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
    _C.MODEL.SEM_SEG_HEAD.CONVS_DIM = 128
    _C.MODEL.SEM_SEG_HEAD.COMMON_STRIDE = 4
    _C.MODEL.SEM_SEG_HEAD.NORM = "GN"
    _C.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 1.0

    # ------------------------------------------------------------------ INPUT
    _C.INPUT = CN()
    _C.INPUT.MIN_SIZE_TRAIN = (800,)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 1333
    _C.INPUT.MIN_SIZE_TEST = 1600
    _C.INPUT.MAX_SIZE_TEST = 1600
    _C.INPUT.MAX_UPSCALE_RATIO = 2
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.CROP = CN()
    _C.INPUT.CROP.ENABLED = False
    _C.INPUT.CROP.TYPE = "relative_range"
    _C.INPUT.CROP.SIZE = [0.9, 0.9]
    _C.INPUT.FORMAT = "BGR"
    _C.INPUT.MASK_FORMAT = "polygon"
    _C.INPUT.ROTATION = CN()
    _C.INPUT.ROTATION.ENABLED = False
    _C.INPUT.ROTATION.ANGLES = [0]

    # --------------------------------------------------------------- DATASETS
    _C.DATASETS = CN()
    _C.DATASETS.TRAIN = []
    _C.DATASETS.TEST = []
    _C.DATASETS.ROOT = "."
    _C.DATASETS.CONFIG = ""
    _C.DATASETS.PROPOSAL_FILES_TRAIN = []
    _C.DATASETS.PROPOSAL_FILES_TEST = []
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000
    _C.DATASETS.AUG = False
    _C.DATASETS.RANDOM_CROP_PROB = 0.0
    _C.DATASETS.IGNORE_DIFFICULT = False
    _C.DATASETS.FIX_CROP = False
    _C.DATASETS.CROP_SIZE = (512, 512)
    _C.DATASETS.MAX_ROTATE_THETA = 30
    _C.DATASETS.FIX_ROTATE = False
    # Parameterized evaluation ground-truth archives (the reference hardcodes
    # internal paths at text_evaluator.py:57-74; here they are config values).
    _C.DATASETS.EVAL_GT_ZIPS = CN()
    _C.DATASETS.EVAL_GT_ZIPS.ICDAR15 = ""
    _C.DATASETS.EVAL_GT_ZIPS.TOTALTEXT = ""
    _C.DATASETS.EVAL_GT_ZIPS.TEXTOCR = ""
    _C.DATASETS.LEXICON_DIR = ""

    # ------------------------------------------------------------- DATALOADER
    _C.DATALOADER = CN()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    # ----------------------------------------------------------------- SOLVER
    _C.SOLVER = CN()
    _C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    _C.SOLVER.MAX_ITER = 40000
    _C.SOLVER.BASE_LR = 0.001
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.NESTEROV = False
    _C.SOLVER.WEIGHT_DECAY = 0.0001
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (30000,)
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 1000
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.IMS_PER_BATCH = 16
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.BIAS_LR_FACTOR = 1.0
    _C.SOLVER.WEIGHT_DECAY_BIAS = 0.0001
    _C.SOLVER.CLIP_GRADIENTS = CN()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    _C.SOLVER.AMP = CN()
    _C.SOLVER.AMP.ENABLED = False

    # ------------------------------------------------------------------- TEST
    _C.TEST = CN()
    _C.TEST.EXPECTED_RESULTS = []
    _C.TEST.EVAL_PERIOD = 0
    # RRC CONFIDENCES evaluation param: rank care detections by confidence
    # and report E2E average precision (reference text_eval_script.py:35 —
    # declared but never enabled by its shipped configs).
    _C.TEST.CONFIDENCES = False
    _C.TEST.KEYPOINT_OKS_SIGMAS = []
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.AUG = CN()
    _C.TEST.AUG.ENABLED = False
    _C.TEST.AUG.MIN_SIZES = [400, 500, 600, 700, 800, 900, 1000, 1100, 1200]
    _C.TEST.AUG.MAX_SIZE = 4000
    _C.TEST.AUG.FLIP = True
    _C.TEST.PRECISE_BN = CN()
    _C.TEST.PRECISE_BN.ENABLED = False
    _C.TEST.PRECISE_BN.NUM_ITER = 200
    _C.TEST.IOU_THRESHOLD = 0.5
    _C.TEST.USE_FILTERED_METRICS = True
    _C.TEST.DONT_CARE_GT_LABELS = ["###", ""]
    # Eval-time overrides applied programmatically by the reference
    # (tools/eval_glass.py:82-114) — declared so they can live in YAML too.
    # Benchmark lexicon protocol (reference tools/eval_glass.py:101-104,
    # text_evaluator.py:43,76-81; path knobs replace lexicon_utils.py's
    # hardcoded EFS paths): 0 none, 1 generic, 2 weak, 3 per-image strong.
    _C.TEST.LEXICON_TYPE = 0
    _C.TEST.LEXICON_WEIGHTED = False
    _C.TEST.LEXICON_PATH = ""          # types 1/2: lexicon txt
    _C.TEST.LEXICON_PAIRS_PATH = ""    # types 1/2: optional pairs txt
    _C.TEST.STRONG_LEXICON_DIR = ""    # type 3: dir of new_voc_img_<i>.txt
    _C.EDIT_DISTANCE_THR = 1.5
    _C.IS_WORD_SPOTTING = False

    # -------------------------------------------------------- POST_PROCESSING
    _C.POST_PROCESSING = CN()
    _C.POST_PROCESSING.NAME = "PostProcessorAcademic"
    _C.POST_PROCESSING.SKIP_ALL = False
    # Run the merge fixpoint on-device (device_merge.py) instead of the
    # host numpy loop. Best on locally-attached chips; off by default for
    # high-latency tunneled backends.
    _C.POST_PROCESSING.ON_DEVICE = False
    _C.POST_PROCESSING.BOX_INFLATE_RATIO = 0.05
    _C.POST_PROCESSING.BOX_PX_PADDING = [0, 0, 0, 0]
    _C.POST_PROCESSING.MIN_BOX_DIMENSION = 2
    _C.POST_PROCESSING.MAX_OUTSIDE_BOX_MARGIN_PX = 5
    _C.POST_PROCESSING.MERGE_IOA_THRESH = 0.3
    _C.POST_PROCESSING.OVERLAP_WIDTH_PER_HEIGHT_THRESH = 0.3
    _C.POST_PROCESSING.PAIRS_HEIGHT_RATIO_THRESH = 0.35
    _C.POST_PROCESSING.LOW_CONFIDENCE = 0.01
    _C.POST_PROCESSING.VALID_CONFIDENCE = 0.15
    _C.POST_PROCESSING.DETECT_THRESHOLD = 0.25
    _C.POST_PROCESSING.TEXT_THRESHOLD = 0.25
    _C.POST_PROCESSING.MAX_ANGLE_DIFF = 15
    # Optional runtime keys the reference reads via hasattr()
    # (glass_rcnn.py:40-53); -1.0 / False mean "absent".
    _C.POST_PROCESSING.INFLATE_RATIO = 0.0
    _C.POST_PROCESSING.TRANSCRIPT_FILTERING = False
    _C.POST_PROCESSING.DROP_OVERLAPPING = False
    _C.POST_PROCESSING.IOA_THRESHOLD = 0.2
    _C.POST_PROCESSING.MERGE_MAX_ITERS = 8

    # Reference eval_glass.py:84-85 sets these as root-level attributes.
    _C.INFERENCE_TH_TEST = 0.0
    _C.INFERENCE_DETECTION_TH_TEST = 0.0

    # -------------------------------------------------------------------- TPU
    # TPU-native execution knobs (no reference counterpart): everything under
    # jit must be statically shaped, so the dynamic collections of the
    # reference (proposal lists, word batches) become fixed-capacity padded
    # arrays with validity masks.
    _C.TPU = CN()
    _C.TPU.PAD_IMAGE_TO_MULTIPLE = 32
    # Static capacity buckets for the padded test-image resolution.
    _C.TPU.IMAGE_BUCKETS = [
        [704, 1280], [1280, 704], [1024, 1024],
        [960, 1600], [1600, 960], [1280, 1280],
        [1280, 1600], [1600, 1280], [1600, 1600],
    ]
    # Fixed [H, W] train batch padding: static shape for every batch (no
    # per-shape recompiles; required for multi-host). Empty = per-batch max.
    _C.TPU.TRAIN_PAD_SIZE = []
    _C.TPU.MAX_DETECTIONS = 100       # capacity of the padded detection set
    _C.TPU.MAX_WORDS = 128            # recognizer batch capacity at inference
    _C.TPU.MAX_GT_INSTANCES = 256     # padded ground-truth capacity (train)
    # Padded gt-polygon vertex capacity (data/loader.py). Longer polygons
    # are evenly subsampled before the in-graph mask-target rasterization
    # (train/targets.py); the reference rasterizes full polygons on the
    # host (rotated_mask_head.py:269-322).  64 covers curved-text gt
    # (TotalText-style annotations run ~20-40 vertices).
    _C.TPU.MAX_POLY_VERTICES = 64
    # Exact-rotated-IoU candidate pool of the RPN anchor matcher
    # (train/matcher.py::rpn_label_anchors); matching is exact while the
    # number of anchors whose IoU upper bound clears the ignore threshold
    # stays within the pool.  The per-step `matcher_pool_dropped` metric
    # counts overflow candidates and the trainer warns when it is nonzero;
    # set 0 to auto-size from MAX_GT_INSTANCES instead
    # (matcher.auto_match_pool: ~416 candidates/gt, floor 16384 — exact in
    # gt-dense regimes at ~25% extra step time).
    _C.TPU.MATCH_POOL = 16384
    # RPN anchor-matcher backend: "tiled" (hierarchical tile pre-filter —
    # the bound first runs on ~400*K inflated tile covers, then only live
    # tiles' anchors are materialized; exact up to the same pool rules,
    # see matcher.rpn_label_anchors_tiled) or "scan" (blockwise bound
    # over the full anchor axis).  Default set by the round-4 on-chip
    # interleaved A/B: tiled+pool 86.8 vs scan+axis 90.7 ms/step at
    # G=24 (89.5 vs 94.4 at G=100), PERF_NOTES round 4.
    _C.TPU.MATCH_BACKEND = "tiled"
    # Live-tile pool capacity of the tiled matcher (each tile covers 16x16
    # grid cells of one cell-anchor type); overflow is surfaced as the
    # `matcher_tile_dropped` metric.
    _C.TPU.MATCH_TILE_CAP = 512
    # RPN fg/bg subsampler: "pool" (samples positives from the matcher
    # pools and negatives by rejection — no million-anchor pass; requires
    # MATCH_BACKEND="tiled"; see matcher.subsample_rpn_from_pools) or
    # "axis" (priorities + top-k over the anchor axis).  Default set by
    # the same round-4 A/B as MATCH_BACKEND above.
    _C.TPU.RPN_SAMPLER = "pool"
    # In-graph multi-step training: K minibatches staged + dispatched as
    # ONE jit program (lax.scan over K optimizer steps, params feedback as
    # the scan carry). Amortizes per-dispatch latency; step-for-step
    # identical to K=1 (same per-iteration PRNG stream; checkpoint/eval/
    # vis land on their exact iterations). 1 = dispatch per step.
    _C.TPU.TRAIN_LOOP_STEPS = 1
    # Restrict the training data mesh to the first N local devices
    # (0 = all). IMS_PER_BATCH must divide by the mesh size; this knob
    # lets small-batch runs train on a machine with more devices.  In the
    # port: the processes `python -m glass_tpu_torch.train` spawns, one per
    # GPU (0 = every visible GPU; on --device cpu, N gloo ranks, 0 = one).
    _C.TPU.TRAIN_DEVICES = 0
    # Box/mask pooler kernel backend: "xla" (packed-pyramid gather,
    # default) or "pallas" (DMA-tile kernel — bit-exact alternative,
    # measured slower on v5e; see ops/pallas_roi_align.py).
    _C.TPU.ROI_ALIGN_BACKEND = "xla"
    # Single-process SPMD serving: shard eval batches over all local
    # devices (inference/runner.py::dispatch_batch). One program drives
    # the serving pod — the TPU answer to the reference's
    # one-process-per-GPU launch().  In the port: one replica per visible
    # GPU in one process, the batch rows split over them.
    _C.TPU.SERVE_DATA_PARALLEL = False
    # Batched-serving realisation: "map" runs the hand-tuned single-image
    # program sequentially per batch row inside one jit (lax.map) — each
    # row keeps its REAL lax.cond branches (adaptive pooler split, dead
    # block skipping) and single-row gather layouts. "vmap" vectorizes the
    # batch dim instead, which flattens every cond to execute-both-branches
    # select and re-tiles the gathers — measured 2.6x SLOWER end-to-end on
    # v5e (b=4: 35.5 ms/img map vs 94 ms/img vmap, round-5 A/B). Outputs
    # of "map" are bit-identical to the b=1 serving path by construction.
    _C.TPU.SERVE_BATCH_MODE = "map"
    # Thread-pool width for per-image host post-processing inside
    # eval_batch_call (numpy releases the GIL). 0 = sequential.
    _C.TPU.POSTPROCESS_WORKERS = 0
    # eval_batch_call pipeline: fetch finished batches on a worker thread
    # (device->host copies release the GIL) so the transfer overlaps host
    # post-processing of the previous chunk. False = 1-deep pipeline.
    _C.TPU.ASYNC_FETCH = True
    _C.TPU.COMPUTE_DTYPE = "bfloat16"  # conv/matmul compute dtype
    # Raw-image crop pooler sampling grid (static!). The reference uses a
    # fixed 2x2 grid per output bin; at 128x128 output the bins of typical
    # word crops are sub-pixel, where detectron2's own adaptive rule
    # (ceil(extent/out)) would pick 1 — so 1 is numerically ~equivalent at a
    # quarter of the gather cost. Set 2 for strict parity, 0 for adaptive
    # masking (same cost as CROP_MAX_SAMPLING_RATIO).
    _C.TPU.CROP_SAMPLING_RATIO = 1
    # Raw-image crop pooler backend: "auto" (= the XLA gather — the
    # round-4 frame A/B measured the Pallas kernel slower in situ, 46.6
    # vs 38.7 ms/frame; see models/glass_rcnn.py::resolved_crop_backend),
    # "pallas" (explicit opt-in tile-DMA kernel), or "xla".
    _C.TPU.CROP_BACKEND = "auto"
    _C.TPU.CROP_MAX_SAMPLING_RATIO = 2
    # Split-capacity realisation of d2's adaptive (sampling_ratio=0) pooling
    # grids: bulk static grid POOL_BULK_SAMPLING_RATIO for every roi plus a
    # full POOL_MAX_SAMPLING_RATIO grid for up to POOL_LARGE_ROI_BUDGET rois
    # that need it (bit-exact vs a monolithic max-grid pass unless more rois
    # than the budget exceed the bulk grid; overflow rois get the bulk grid).
    # BULK=0 disables the split (single max-grid pass).
    _C.TPU.POOL_MAX_SAMPLING_RATIO = 4
    _C.TPU.POOL_BULK_SAMPLING_RATIO = 2
    _C.TPU.POOL_LARGE_ROI_BUDGET = 16
    # Per-pooler bulk grids, (grid_h, grid_w). Word boxes are anisotropic:
    # on their (usually clamped-lowest) FPN level a typical word spans
    # <14 px vertically and <=2x14 px horizontally, so d2's adaptive grid at
    # the 14x14 mask pooler is (1, 2) and at the 8x32 recognizer pooler
    # (2, 1). Matching per-axis bulk passes + the LARGE_ROI_BUDGET
    # full-grid pass stay exact for those statistics at half the gather and
    # backward-scatter traffic. Set (2, 2) to mirror the box pooler's bulk.
    _C.TPU.MASK_POOL_BULK_SAMPLING_RATIO = (1, 2)
    _C.TPU.RECOGNIZER_POOL_BULK_SAMPLING_RATIO = (2, 1)
    # Recognizer host-fetch representation: "topk" = on-device argmax ids +
    # per-step max probs (12x smaller transfer; sufficient for argmax
    # decoding). "probs" = full (T, V) distributions — REQUIRED when lexicon
    # correction uses the weighted edit distance (TEST.LEXICON_WEIGHTED /
    # --weighted-ed); tools/eval_glass.py switches automatically.
    _C.TPU.TEXT_EMIT = "topk"
    # mask probs fetch dtype: float32 | float16 | uint8 (1/255-quantized on
    # device, dequantized by the runner; consumer is a 0.5 threshold)
    _C.TPU.MASK_FETCH_DTYPE = "float16"
    # Eval/batched path: resize + upload uint8 images and normalize on
    # device (the reference uploads uint8 and converts on-device too,
    # glass_runner.py:133-134; detectron2's eval mapper resizes uint8).
    _C.TPU.EVAL_UINT8_TRANSFER = True
    _C.TPU.PARAM_DTYPE = "float32"
    # Read nowhere, in glass_tpu as in the port: training always syncs BN
    # over the data group (parallel/mesh.py).
    _C.TPU.MESH_AXES = ["data"]
    _C.TPU.SYNC_BN = True             # psum batch stats across the data axis
    # Rematerialize the backbone in the training backward pass (trade ~1.3x
    # FLOPs for activation memory — enables larger per-chip batches).
    _C.TPU.REMAT_BACKBONE = False
    # Training-path stem conv formulation: "s2d4" | "s2d" | "plain".
    # Bit-equivalent math; s2d4 is the measured fwd+dW winner on v5e
    # (6.5 vs 11.1 vs 15.0 ms at 1024^2; records/stem_variants2_r5.log,
    # in-situ A/B in PERF_NOTES round 5).
    _C.TPU.STEM_BACKEND = "s2d4"
    # Two-stage inference: detect first, then run the recognizer at the
    # smallest word-count bucket covering the actual detections.  Saves
    # recognizer work on sparse images at the cost of one host round-trip
    # between stages (a win on locally-attached chips).
    _C.TPU.TWO_STAGE_INFERENCE = False
    _C.TPU.WORD_BUCKETS = [8, 16, 32, 64]

    return _C
