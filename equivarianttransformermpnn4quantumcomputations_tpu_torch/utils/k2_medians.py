"""Medians of ``chip_smoke.py``'s K2 rows over many runs of two trees.

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.k2_medians \
        --change LOG [LOG ...] --parent LOG [LOG ...]

Each LOG is the output of one ``chip_smoke.py --s2act-only`` run (or a full
run).  For every K2 row (kernel, site) it prints, per dtype, the median
CUDA-event and device-only times of each tree, the change's device-only
range, the ratio of the device medians (parent / change), the row's bound
and the change's share of it (bound / median device time), the bound read
from the change's first log.  It reads only the logs: no card is needed.
"""

from __future__ import annotations

import argparse
import re
import statistics

_ROW = re.compile(
    r"kernel (s2act\.k\d) (.+?) (\[[\d,]+\]) P=(\d+)\s+"
    r"f32: ms ([\d.]+), device ms ([\d.]+), bound ([\d.]+) \((\w+).*?"
    r"bf16: ms ([\d.]+), device ms ([\d.]+), bound ([\d.]+) \((\w+)")


def read(logs: list[str]) -> dict[tuple, list[dict]]:
    """Per (kernel, site, shape, P): one dict of numbers per log."""
    rows: dict[tuple, list[dict]] = {}
    for path in logs:
        with open(path) as f:
            for line in f:
                m = _ROW.match(line)
                if not m:
                    continue
                key = (m.group(1), m.group(2).strip(), m.group(3), int(m.group(4)))
                rows.setdefault(key, []).append({
                    "f32": (float(m.group(5)), float(m.group(6)), float(m.group(7)), m.group(8)),
                    "bf16": (float(m.group(9)), float(m.group(10)), float(m.group(11)),
                             m.group(12)),
                })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--change", nargs="+", required=True, help="logs of the change's runs")
    ap.add_argument("--parent", nargs="+", required=True, help="logs of the parent's runs")
    args = ap.parse_args(argv)
    change, parent = read(args.change), read(args.parent)
    for key, runs in change.items():
        kname, site, shape, P = key
        parts = []
        for dt in ("f32", "bf16"):
            ev = statistics.median(r[dt][0] for r in runs)
            dev = [r[dt][1] for r in runs]
            med = statistics.median(dev)
            b_ms, b_by = runs[0][dt][2], runs[0][dt][3]
            old = [r[dt][1] for r in parent.get(key, [])]
            old_ev = [r[dt][0] for r in parent.get(key, [])]
            old_txt = (f", parent events {statistics.median(old_ev):.4f}, device "
                       f"{statistics.median(old):.4f} (x{statistics.median(old) / med:.2f}, "
                       f"n={len(old)})" if old else ", parent not measured")
            parts.append(f"{dt}: events {ev:.4f}, device {med:.4f} [{min(dev):.4f}-"
                         f"{max(dev):.4f}] (n={len(dev)}){old_txt}, bound {b_ms:.4f} "
                         f"({b_by}, {100 * b_ms / med:.0f} %)")
        print(f"{kname} {site} {shape} P={P}: " + "; ".join(parts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
