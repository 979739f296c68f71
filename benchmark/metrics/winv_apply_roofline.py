"""Share of its roofline that the batched W apply reaches
(``ops/winv_apply.py::winv_apply_fused``): the least time of each call's
bytes (or flops) at the card's peak, counted from W's and the vectors'
shapes, over the device time of the kernels launched inside the calls
(phase C)."""

from benchmark import yardstick


def _work(W, d, s, b, *args, **kwargs):
    return yardstick.winv_apply_work(tuple(W.shape), b.shape[-1], W.element_size())


KERNELS = {"winv_apply": ("parapint_tpu_torch.ops.winv_apply", {"winv_apply_fused": _work})}


def read(data):
    device_s = data.kernel_device_s.get("winv_apply", 0.0)
    return 100.0 * data.kernel_bound_s["winv_apply"] / device_s if device_s > 0 else None
