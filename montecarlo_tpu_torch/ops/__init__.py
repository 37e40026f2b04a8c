"""Dense linear algebra (plain PyTorch) and the hand-written CUDA kernels of
the DQMC sweep: site_sweep (K1), udt_qr (K2), udt_qr_solve (K3)."""

from . import qr, site_sweep

# the kernel wrappers, each with its plain-integer launch count `.launches`
KERNELS = {"site_sweep": site_sweep.site_sweep, "udt_qr": qr.udt_qr,
           "udt_qr_solve": qr.udt_qr_solve}

__all__ = ["KERNELS", "qr", "site_sweep"]
