"""The float64 NumPy oracle of the SLAM pipeline (`oracle`), the CPU baseline of `cli bench`."""
