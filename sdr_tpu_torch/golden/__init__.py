"""Numpy reference code the port keeps its own copies of: filter design
(``filters``) and the host RDS symbol/bit/frame chain (``rds``)."""
