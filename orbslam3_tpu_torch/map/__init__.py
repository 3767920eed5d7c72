"""Fixed-capacity structure-of-arrays SLAM map."""
