"""Detector zoo of the port (counterpart of frlw_evd_tpu/models): the AED
family, with decode, NMS and the SimOTA training loss."""

from .detector import EventDetector, build_detector, detector_loss, eval_decode
from .postprocess import postprocess_batch, postprocess_image

__all__ = ["EventDetector", "build_detector", "detector_loss", "eval_decode",
           "postprocess_batch", "postprocess_image"]
