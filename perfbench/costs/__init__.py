"""The frozen yardstick: published peaks, the kernels' and the model's
operation and byte counts."""
