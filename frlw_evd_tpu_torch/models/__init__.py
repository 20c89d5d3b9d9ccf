"""Detector zoo of the port (counterpart of frlw_evd_tpu/models): the AED
and yolox families with decode, NMS, seq-NMS and the SimOTA training
loss; the recurrent convlstm / recconv detector (`MemoryEventDetector`);
the yolov3 (`models.yolov3`) and red (`models.red`) families with their
own losses and decodes."""

from .detector import (EventDetector, MemoryEventDetector, build_detector,
                       build_memory_detector, detector_loss, eval_decode,
                       rollout_memory_detector)
from .postprocess import (finalize_detections, postprocess_batch,
                          postprocess_image)
from .red import REDDetector
from .yolov3 import YOLOv3Detector

__all__ = ["EventDetector", "MemoryEventDetector", "REDDetector",
           "YOLOv3Detector", "build_detector", "build_memory_detector",
           "detector_loss", "eval_decode", "finalize_detections",
           "postprocess_batch", "postprocess_image",
           "rollout_memory_detector"]
