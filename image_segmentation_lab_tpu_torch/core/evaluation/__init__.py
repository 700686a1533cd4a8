from .instance_ap import (IOU_THRESHOLDS, InstanceAPEvaluator,  # noqa: F401
                          mask_iou)
from .instances import instances_to_json, mask_to_rle, rle_to_mask  # noqa: F401,E501
from .metrics import SegEvaluator  # noqa: F401
from .panoptic import (INSTANCE_OFFSET, PanopticEvaluator,  # noqa: F401
                       panoptic_quality, queries_to_panoptic,
                       semantic_to_panoptic)
