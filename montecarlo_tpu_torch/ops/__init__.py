"""Dense linear algebra (plain PyTorch) and the hand-written CUDA kernels of
the DQMC sweep: site_sweep (K1), its float64 instance site_sweep_f64, its
delay-2 paired-site form site_sweep_pair (K5), its one-chain entry
site_sweep_single (K12) and its form with the slice's wrap fused in
site_sweep_wrap (K13), udt_qr (K2), udt_qr_solve (K3), the unfused
Householder QR qr_f32 (K4) and qr_f64 (K11) and the one emitting its
reflectors qr_vtau (K14), site_sweep_delayed (K6) and qr_blocked (K7) for
N > 128, and for complex hopping site_sweep_cx (K8) and qr_cx (K10) for
N <= 128 and site_sweep_delayed_cx (K9) beyond; their float64 and
complex128 instances site_sweep_delayed_f64 (K6-f64), site_sweep_cx_c128
(K8-c128) and site_sweep_delayed_cx_c128 (K9-c128); for the Ising model the
checkerboard Metropolis sweep ising_sweep (K17) and the Wolff BFS level
wolff_step (K18)."""

from . import (ising, qr, qr_blocked, qr_cx, qr_householder, site_sweep,
               site_sweep_cx, site_sweep_delayed, site_sweep_delayed_cx)

# the kernel wrappers, each with its plain-integer launch count `.launches`
KERNELS = {"site_sweep": site_sweep.site_sweep, "udt_qr": qr.udt_qr,
           "udt_qr_solve": qr.udt_qr_solve,
           "site_sweep_delayed": site_sweep_delayed.site_sweep_delayed,
           "qr_blocked": qr_blocked.qr_blocked,
           "site_sweep_cx": site_sweep_cx.site_sweep_cx,
           "qr_cx": qr_cx.qr_cx,
           "qr_f32": qr_householder.qr_f32,
           "qr_f64": qr_householder.qr_f64,
           "site_sweep_f64": site_sweep.site_sweep_f64,
           "site_sweep_pair": site_sweep.site_sweep_pair,
           "site_sweep_delayed_cx": site_sweep_delayed_cx.site_sweep_delayed_cx,
           "site_sweep_wrap": site_sweep.site_sweep_wrap,
           "qr_vtau": qr_householder.qr_vtau,
           "site_sweep_single": site_sweep.site_sweep_single,
           "site_sweep_delayed_f64": site_sweep_delayed.site_sweep_delayed_f64,
           "site_sweep_cx_c128": site_sweep_cx.site_sweep_cx_c128,
           "site_sweep_delayed_cx_c128":
               site_sweep_delayed_cx.site_sweep_delayed_cx_c128,
           "ising_sweep": ising.ising_sweep,
           "wolff_step": ising.wolff_step}

__all__ = ["KERNELS", "ising", "qr", "qr_blocked", "qr_cx", "qr_householder",
           "site_sweep", "site_sweep_cx", "site_sweep_delayed",
           "site_sweep_delayed_cx"]
