"""k2_roofline_pct: K2 from the target (`p2plane_pick_fused_terms`, the
kernel `pick_from_target_kernel`) against its roofline over the profiled
slice: the least time its calls could take, each the larger of the bytes
its inputs need over the card's memory rate and its float32 operations over
the card's float32 rate (`_roofline`), over K2's device time in the slice.
A call's bytes are counted at its scan's result pose; the least time of a
call is the mean over the profiled scans, times the K2 calls the slice
recorded."""

from yardstick import cell

_roofline = cell.load_module("metrics", "_roofline")

KERNEL = "pick_from_target_kernel"


def _is_k2(name: str) -> bool:
    return KERNEL in name and "batch" not in name


def read(record):
    sl, work = record.get("slice"), record.get("k2")
    if sl is None or not work:
        return None
    k2 = [(s, e) for name, s, e in sl.events if _is_k2(name)]
    if not k2:
        return None
    bounds = []
    for w in work:
        tg, T = w["target"], w["pose"]
        n_bytes = _roofline.k2_bytes(w["q"], w["mask"], T[:3, :3], T[:3, 3], tg.origin, tg.leaf,
                                     tg.lo, tg.dims, tg.table)
        bounds.append(_roofline.bound_s(n_bytes, _roofline.k2_flops(w["q"].shape[0])))
    device_s = sum(e - s for s, e in k2) * 1e-6
    return 100.0 * sum(bounds) / len(bounds) * len(k2) / device_s
