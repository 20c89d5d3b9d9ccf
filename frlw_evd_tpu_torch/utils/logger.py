"""Run logging (counterpart of frlw_evd_tpu/utils/logger.py; reference
core/yolox/utils/logger.py: loguru with a per-run file sink and stdout
mirroring, here stdlib logging with the same surface)."""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional


def setup_logger(save_dir: Optional[str] = None, distributed_rank: int = 0,
                 filename: str = "log.txt", mode: str = "a"
                 ) -> logging.Logger:
    """The package's logger: stdout on rank 0 only (the other ranks stay
    silent, as the reference's do) and, on rank 0 when save_dir is given,
    a file sink `file_<stamp>_<filename>` in it."""
    logger = logging.getLogger("frlw_evd_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    if distributed_rank != 0:
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(message)s", "%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        fh = logging.FileHandler(
            os.path.join(save_dir, f"file_{stamp}_{filename}"), mode=mode)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
