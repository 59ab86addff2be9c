"""``python -m kubeoperator_tpu_torch.aot {list,warm,purge,status}
[names] [--cache DIR] [--force]``: the port's counterpart of ``ko aot``
(``kubeoperator_tpu/ctl.py cmd_aot``), with the same output lines.
``list``, ``status`` and ``purge`` are file operations; ``warm`` builds
the catalog's libraries with nvcc on the card.

    python -m kubeoperator_tpu_torch.aot warm train-k7k8 --cache DIR
    python -m kubeoperator_tpu_torch.aot list --cache DIR
"""

from __future__ import annotations

import argparse
import sys


def table(rows: list[dict], columns: list[str]) -> None:
    if not rows:
        print("(none)")
        return
    widths = [max(len(c), *(len(str(r.get(c, ""))) for r in rows))
              for c in columns]
    print("  ".join(c.upper().ljust(w) for c, w in zip(columns, widths)))
    for r in rows:
        print("  ".join(str(r.get(c, "")).ljust(w)
                        for c, w in zip(columns, widths)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kubeoperator_tpu_torch.aot",
        description="persistent compile-artifact cache of the port's "
                    "kernel libraries (zero-build bring-up)")
    p.add_argument("action", choices=("list", "warm", "purge", "status"))
    p.add_argument("names", nargs="*",
                   help="warm: catalog entries (default serve-smoke "
                        "train-smoke); purge: one fingerprint")
    p.add_argument("--cache", default="",
                   help="cache directory (default $KO_AOT_CACHE or "
                        "~/.cache/kubeoperator-tpu-torch/aot)")
    p.add_argument("--force", action="store_true",
                   help="purge: also remove entries in use")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from kubeoperator_tpu_torch.aot import CATALOG, CompileCache, warm

    cache = CompileCache(args.cache or None)
    if args.action == "list":
        rows = []
        for r in cache.entries():
            rows.append({"name": r["name"], "fingerprint": r["fingerprint"],
                         "kind": r["kind"],
                         "mesh": cache.meta(r).get("mesh", "?"),
                         "KiB": f"{r['size_bytes'] / 1024:.0f}",
                         "in_use": "yes" if r["in_use"] else ""})
        table(rows, ["name", "fingerprint", "kind", "mesh", "KiB", "in_use"])
        return 0
    if args.action == "status":
        s = cache.status()
        print(f"{s['root']}: {s['count']} artifact(s), "
              f"{s['total_bytes'] / 1024:.0f} KiB, "
              f"hits {s['hits']} misses {s['misses']}")
        return 0
    if args.action == "warm":
        from kubeoperator_tpu_torch import kernels

        kernels._nvcc()             # warming builds on the card's machine
        try:
            rows = warm(cache, args.names or None)
        except KeyError as e:
            print(f"error: unknown catalog entry {e} "
                  f"(have: {', '.join(sorted(CATALOG))})", file=sys.stderr)
            return 1
        for r in rows:
            state = ("nothing to build" if r["source"] == "none"
                     else "hit (already warm)" if r["hit"]
                     else f"compiled ({r['source']})")
            print(f"{r['entry']}/{r['function']}: {state} "
                  f"in {r['seconds']:.2f}s → {r['fingerprint']}")
        return 0
    # purge: in-use entries (this process, or any live pid's in_use.json
    # marker) are refused without --force, so a running worker's library
    # never loses its file
    out = cache.purge(args.names[0] if args.names else None, force=args.force)
    for fp in out["removed"]:
        print(f"removed {fp}")
    for fp in out["refused"]:
        print(f"refused {fp}: in use by a running engine (--force overrides)",
              file=sys.stderr)
    return 1 if out["refused"] else 0


if __name__ == "__main__":
    sys.exit(main())
