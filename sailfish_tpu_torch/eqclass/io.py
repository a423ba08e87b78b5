"""Equivalence-class dump IO: the checkpoint / cross-host exchange
format.

The reference's only mid-pipeline artifact is `--dumpEq`'s
aux/eq_classes.txt (src/GZipWriter.cpp:51-92); a resume path existed but
was disabled (src/SailfishQuantify.cpp:1444-1495).  Here the dump is a
first-class checkpoint: `quant --resumeFromEq` re-runs inference +
outputs from it, and `mergeeq` sums dumps from sharded runs (the
cross-host merge artifact of SURVEY §5)."""

from __future__ import annotations

import os

from .classes import EqClassAccumulator, EqClasses


def read_eq_classes(path: str) -> tuple[list[str], EqClasses]:
    """Parse an aux/eq_classes.txt dump -> (transcript names, classes)."""
    with open(path) as fh:
        num_txps = int(fh.readline())
        num_classes = int(fh.readline())
        names = [fh.readline().strip() for _ in range(num_txps)]
        acc = EqClassAccumulator()
        for _ in range(num_classes):
            toks = fh.readline().split()
            size = int(toks[0])
            label = tuple(int(t) for t in toks[1 : 1 + size])
            count = int(toks[1 + size])
            acc.add(label, count)
    return names, acc.finish()


def write_eq_dump(
    path: str, names: list[str], eq: EqClasses, atomic: bool = False
) -> None:
    """Write an aux/eq_classes.txt dump (src/GZipWriter.cpp:51-92 layout).

    With ``atomic`` the dump lands via a same-directory temp file +
    rename, so a crash mid-write never corrupts an existing checkpoint.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp" if atomic else path
    with open(tmp, "w") as fh:
        fh.write(f"{len(names)}\n{eq.num_classes}\n")
        for n in names:
            fh.write(f"{n}\n")
        for i in range(eq.num_classes):
            label = eq.members[eq.offsets[i] : eq.offsets[i + 1]]
            fh.write(
                f"{len(label)}\t"
                + "\t".join(str(int(t)) for t in label)
                + f"\t{int(eq.counts[i])}\n"
            )
    if atomic:
        os.replace(tmp, path)


def merge_eq_dumps(paths: list[str]) -> tuple[list[str], EqClasses]:
    """Sum eq-class dumps from sharded runs (labels are canonical, so
    the merge is a pure dictionary sum)."""
    names0 = None
    acc = EqClassAccumulator()
    for p in paths:
        names, eq = read_eq_classes(p)
        if names0 is None:
            names0 = names
        elif names != names0:
            raise ValueError(
                f"eq-class dumps disagree on transcript names: {p}"
            )
        for i, label in enumerate(eq.labels()):
            acc.add(label, int(eq.counts[i]))
    return names0 or [], acc.finish()


def find_eq_dump(run_dir: str, aux_dir: str = "aux") -> str:
    """Locate the dump inside a quant output directory (or accept a
    direct file path)."""
    if os.path.isfile(run_dir):
        return run_dir
    cand = os.path.join(run_dir, aux_dir, "eq_classes.txt")
    if os.path.isfile(cand):
        return cand
    raise FileNotFoundError(f"no eq_classes.txt under {run_dir}")
