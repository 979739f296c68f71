"""Dense compute kernels: batched LDL^T with W = L^{-1}, banded storage."""
