"""IMU preintegration (Forster et al.)."""
