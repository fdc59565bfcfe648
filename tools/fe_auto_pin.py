"""Measure the band that bench_torch.py's fe_auto pin is taken from.

    python tools/fe_auto_pin.py [runs]      # on the card, default 6 runs

Runs ``python bench_torch.py`` ``runs`` times in turn, each a process of
its own as a user starts it, and reads ``fe_auto_vs_baseline`` (with its
setup and solve seconds) from each JSON line.  Prints every reading, the
card's name and power limit (``nvidia-smi``), the lowest reading, the
spread (highest less lowest) and the pin they give: the lowest reading
less the spread (``bench_torch.FE_AUTO_PIN``).  The last line is one JSON
object with all of it.  The SPE01 stanza finds no files (it reports its
error and does not touch the fe_auto reading, which comes before it).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    runs = int(argv[0]) if argv else 6
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    readings = []
    for k in range(runs):
        proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        d = json.loads(proc.stdout.splitlines()[-1])["detail"]
        if "fe_auto_vs_baseline" not in d:
            print(f"run {k + 1}: no fe_auto reading: "
                  f"{d.get('general_error')}", file=sys.stderr)
            return 1
        row = {key: d[f"fe_auto_{key}"] for key in (
            "vs_baseline", "setup_s", "solve_s", "inner_iters")}
        row["warn"] = d.get("fe_auto_warn")
        readings.append(row)
        print(f"run {k + 1}: fe_auto_vs_baseline {row['vs_baseline']} "
              f"(setup {row['setup_s']} s, solve {row['solve_s']} s, "
              f"{row['inner_iters']} inner iterations)", flush=True)
    vs = [r["vs_baseline"] for r in readings]
    low, spread = min(vs), round(max(vs) - min(vs), 3)
    print(f"lowest {low}, spread {spread}, pin {round(low - spread, 3)}")
    print(json.dumps({"card": smi, "readings": readings, "lowest": low,
                      "spread": spread, "pin": round(low - spread, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
