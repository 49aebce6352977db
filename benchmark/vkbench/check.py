"""The comparison that decides ``correct``: a frame of the timed window
against the reference's frame of the same pose.

Per compared frame, each number below; a run's number is its worst frame,
and a run is correct when every number is at or under its limit (the
configuration's ``limits``), every frame's overflow counters are 0, and
at least one frame was compared.

- ``vis_tid_pct``: share (%) of pixels whose visible triangle after the
  masked pass differs;
- ``vis_depth_err``: the largest |depth difference| after the masked
  pass on the pixels whose triangle is the same;
- ``shadow_err``: the largest |difference| of a shadow texel's quantized
  depth, in depth units (the maps' 16-bit fixed point: 1/65535);
- ``color_pct``: share (%) of pixels whose ``color_u8`` differs in any
  channel;
- ``color_err``: the largest |difference| of one ``color_u8`` channel;
- ``overflow_err``: the largest |difference| of the overflow counters of
  ``stats_vec`` (bin, peel, sparse).
"""

from __future__ import annotations

NUMBERS = ("vis_tid_pct", "vis_depth_err", "shadow_err", "color_pct",
           "color_err", "overflow_err")
SHADOW_Q = 65535.0
OVERFLOW = slice(2, 5)     # stats_vec: bin_overflow, peel_overflow,
                           # sparse_overflow (graph/frame.STATS_KEYS)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of one frame: ``prog`` holds the program's captured
    ``depth``, ``tid``, ``shadow_maps``, ``color_u8`` and ``stats_vec``,
    ``ref`` the reference's, on one device."""
    import torch
    dev = ref["tid"].device
    p = {k: v.to(dev) for k, v in prog.items()}
    same = p["tid"] == ref["tid"]
    n_px = same.numel()
    depth_err = (p["depth"] - ref["depth"]).abs()
    depth_err = float(torch.where(same, depth_err, 0.0).max())
    qp = p["shadow_maps"] & 0xFFFF
    qr = ref["shadow_maps"] & 0xFFFF
    shadow = (float((qp - qr).abs().max()) / SHADOW_Q
              if qp.shape == qr.shape else float("inf"))
    cp = p["color_u8"].to(torch.int16)
    cr = ref["color_u8"].to(torch.int16)
    diff = (cp - cr).abs()
    ovf = (p["stats_vec"][OVERFLOW].long()
           - ref["stats_vec"][OVERFLOW].long()).abs()
    return {
        "vis_tid_pct": 100.0 * float((~same).sum()) / n_px,
        "vis_depth_err": depth_err,
        "shadow_err": shadow,
        "color_pct": 100.0 * float((diff > 0).any(-1).sum()) / n_px,
        "color_err": float(diff.max()),
        "overflow_err": float(ovf.max()),
    }


def worst(frames: list[dict]) -> dict:
    return {k: max(f[k] for f in frames) for k in NUMBERS}


def judge(numbers: dict | None, limits: dict, failed: int,
          compared: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) with the run's counts
    beside the numbers."""
    checks = {"frames_compared": {"value": compared, "limit": ">= 1"},
              "frames_overflowing": {"value": failed, "limit": 0}}
    ok = compared >= 1 and failed == 0
    for k in NUMBERS:
        value = None if numbers is None else numbers[k]
        checks[k] = {"value": value, "limit": limits[k]}
        ok = ok and value is not None and value <= limits[k]
    return ok, checks


def lines(checks: dict) -> list[str]:
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in checks.items()]
