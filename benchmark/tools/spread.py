"""Spreads of a cell's runs, for setting the end-to-end bounds.

    python3 benchmark/tools/spread.py <file with result lines> ...

Reads every line that parses as a result (a JSON object with ``metrics``)
and prints, per metric, the values, the median and the spread: the
distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` over the median.
"""
import json
import statistics
import sys


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def results(paths):
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith("{") and '"metrics"' in line:
                    yield json.loads(line)


def main(argv) -> int:
    by = {}
    for r in results(argv):
        for k, m in r["metrics"].items():
            by.setdefault(k, []).append(m["value"])
    for k, vals in sorted(by.items()):
        s = spread(vals) if len(vals) >= 2 else float("nan")
        print(f"{k}: n={len(vals)} median={statistics.median(vals)!r} spread={s!r} "
              f"values={vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
