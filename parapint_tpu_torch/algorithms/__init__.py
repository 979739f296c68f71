from parapint_tpu_torch.algorithms.interior_point import InteriorPointStatus, ip_solve
from parapint_tpu_torch.algorithms.fused import FusedResult, ip_solve_fused, make_fused_ip_solve

__all__ = ["InteriorPointStatus", "ip_solve", "ip_solve_fused", "make_fused_ip_solve", "FusedResult"]
