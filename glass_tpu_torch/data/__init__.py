from .dataset import DatasetManager, load_coco_json, rotated_box_anno_to_xywha
