from .checkpoint import ChainCheckpoint, restore_chain, resume_chain, save_chain
from .kalman import KalmanResult, kalman_filter, kalman_smoother

__all__ = ["ChainCheckpoint", "KalmanResult", "kalman_filter", "kalman_smoother",
           "restore_chain", "resume_chain", "save_chain"]
