from .kalman import KalmanResult, kalman_filter, kalman_smoother

__all__ = ["KalmanResult", "kalman_filter", "kalman_smoother"]
