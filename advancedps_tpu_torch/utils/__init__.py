from .kalman import KalmanResult, kalman_filter

__all__ = ["KalmanResult", "kalman_filter"]
