"""Tiny sizes of each cell for the CPU tests: the traffic shrunk and the
model's capacities cut (64x224 bucket, few proposals, detections and
characters, float32), so that a whole run takes seconds."""

SERVE = ["INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "224", "TPU.IMAGE_BUCKETS", "[[64,224]]",
         "MODEL.RPN.PRE_NMS_TOPK_TEST", "32", "MODEL.RPN.POST_NMS_TOPK_TEST", "8",
         "TEST.DETECTIONS_PER_IMAGE", "4", "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "4",
         "TPU.COMPUTE_DTYPE", "float32"]
TRAIN = ["MODEL.RPN.PRE_NMS_TOPK_TRAIN", "32", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "8",
         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16", "MODEL.ROI_RECOGNIZER_HEAD.MAX_WORD_LENGTH", "5",
         "MODEL.ROI_RECOGNIZER_HEAD.MAX_BATCH_SIZE", "1", "TPU.MAX_GT_INSTANCES", "8",
         "TPU.COMPUTE_DTYPE", "float32"]
EVAL_MIX = {"hw": [48, 160], "pool": 4, "images_per_call": 4, "warmup_images": 4, "compare": 2}
SERVE_MIX = {"hw": [48, 160], "pool": 4, "compare": 2, "compare_among": 3, "trace_requests": 2}
TRAIN_MIX = {"size": 128, "pool": 4, "gts": 4, "trace_steps": 1}

# per loop: (options, traffic overrides)
TINY = {"eval_batch": (SERVE, EVAL_MIX), "serve_call": (SERVE, SERVE_MIX), "train_steps": (TRAIN, TRAIN_MIX)}


def tiny(cell_traffic: dict):
    return TINY[cell_traffic["loop"]]
