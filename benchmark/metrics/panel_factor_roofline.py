"""Share of its roofline that the batched LDL^T panel factorization reaches
(``ops/ldl_panel.py``'s five entries): the least time the bytes (or flops)
of each call need at the card's peak, counted from the panels' shapes, over
the device time of every kernel launched inside the calls (phase C).  It
reads the same work whatever implements the entries."""

from benchmark import yardstick

MODULE = "parapint_tpu_torch.ops.ldl_panel"


def _with_w(A, *args, **kwargs):
    return yardstick.panel_factor_work(tuple(A.shape), True, A.element_size())


def _without_w(A, *args, **kwargs):
    return yardstick.panel_factor_work(tuple(A.shape), False, A.element_size())


KERNELS = {
    "panel_factor": (MODULE, {
        "ldl_panels_slab_winv": _with_w, "ldl_panels_batched_winv": _with_w,
        "ldl_panels_slab": _without_w, "ldl_panels": _without_w, "ldl_panels_batched": _without_w,
    }),
}


def read(data):
    device_s = data.kernel_device_s.get("panel_factor", 0.0)
    return 100.0 * data.kernel_bound_s["panel_factor"] / device_s if device_s > 0 else None
