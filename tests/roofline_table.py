"""The roofline table of the port's dry-run against the JAX package's
closed form: reads the JSON that ``python -m repro_torch.launch.dryrun
--all --both-meshes --roofline --out PATH`` writes and prints, for every
counted cell of one mesh (a row an arch, a column a shape), the three
roofline seconds (compute, memory, collective: the NVIDIA H100 SXM5
80GB data sheet's rates, 700 W), the bottleneck, and the FLOPs of the
mesh over ``benchmarks/roofline.py`` ``analytic_flops`` (the JAX
package's closed form: 8 N D for a train cell under remat full, 2 N D
for a forward, plus the attention and SSD terms): a rank's FLOPs times
every device, since the ranks each run their own blocks (whatever
those repeat counts).  Test-side tooling: it reads the JAX package's
configs.

    PYTHONPATH=src python tests/roofline_table.py build/roofline_torch.json
"""

import argparse
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def analytic():
    spec = importlib.util.spec_from_file_location(
        "roofline_bench", ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.analytic_flops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    flops_of = analytic()
    rows = [r for r in json.loads(Path(args.path).read_text())
            if r.get("mesh") == args.mesh and "per_device" in r]
    shapes = list(dict.fromkeys(r["shape"] for r in rows))
    cells = {}
    for r in rows:
        ratio = r["per_device"]["flops"] * r["devices"] / flops_of(
            r["arch"], r["shape"])
        rt = r["roofline_seconds"]
        cells[r["arch"], r["shape"]] = (
            f"{rt['compute']:.3g} / {rt['memory']:.3g} / "
            f"{rt['collective']:.3g}, {r['bottleneck'][:4]}, {ratio:.2f}")
    print("| arch | " + " | ".join(shapes) + " |")
    print("|---" * (len(shapes) + 1) + "|")
    for arch in dict.fromkeys(r["arch"] for r in rows):
        print(f"| {arch} | " + " | ".join(
            cells.get((arch, s), "—") for s in shapes) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
