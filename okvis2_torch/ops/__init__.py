from okvis2_torch.ops.linalg import inv3x3, spd_inverse_sqrt, spd_solve

__all__ = ["inv3x3", "spd_solve", "spd_inverse_sqrt"]
