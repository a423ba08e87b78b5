"""The benchmark's worlds and read samples, made from seeds.

A world is a transcriptome drawn with the laws its configuration file
states (`gene_structure`: spliced genes and their isoforms;
`single_exon`: unspliced genes), made once per configuration and kept
in the benchmark's cache (`world.npz`).  The reads are made from the
run's seed every run: each fragment's transcript by the traffic's
abundance law (`expression`), then its length, start and errors.  The
read simulator (`simulate`, `padded`) is a frozen copy of
`sailfish_tpu_torch/bench.py`'s `simulate_uniform` / `simulate_batch`
and `padded` at commit f7d73a689aa0; under a flat abundance law it
draws what they draw, which `benchmark/tests` checks.
"""

from __future__ import annotations

import os

import numpy as np

SEP = 4


# ---------------------------------------------------------------- worlds
def lognormal(rng, law: dict, n: int) -> np.ndarray:
    """n whole lengths from a log-normal law given by its median and
    mean (sigma = sqrt(2 ln(mean / median))), at least 1."""
    sigma = np.sqrt(2.0 * np.log(law["mean"] / law["median"]))
    x = rng.lognormal(np.log(law["median"]), sigma, n)
    return np.maximum(np.rint(x), 1).astype(np.int64)


def with_tail(rng, s: np.ndarray, min_len: int):
    """`s`, and a random tail when it is shorter than min_len (so that
    every fragment length of the traffic fits); returns (seq, tail)."""
    if len(s) >= min_len:
        return s, 0
    tail = rng.integers(0, 4, min_len - len(s)).astype(np.uint8)
    return np.concatenate([s, tail]), len(tail)


def gene_structure(rng, w: dict):
    """Spliced genes with the configuration's laws: a gene has
    `exons_per_gene` exons (first, internal and last exon lengths each
    by their law; a one-exon gene takes the last exon's); it has up to
    `transcripts_per_gene` isoforms (geometric by its mean), each
    keeping the first and last exon and each internal exon with
    probability `keep_internal_exon`, no two alike; an isoform shorter
    than `min_len` gets random bases appended.  Genes are drawn until
    `transcripts` isoforms exist.  Returns (names, seqs, structure):
    per transcript its gene and kept-exon bit mask; per segment (a kept
    exon or an appended tail, in transcript order) its transcript, its
    exon index in the gene (-1 for a tail) and its length."""
    seqs, names = [], []
    gene_of, mask_of = [], []
    seg_txp, seg_exon, seg_len = [], [], []
    ex_law, tx_law = w["exons_per_gene"], w["transcripts_per_gene"]
    gene = 0
    while len(seqs) < w["transcripts"]:
        n_ex = int(min(lognormal(rng, ex_law, 1)[0], ex_law["max"]))
        if n_ex == 1:
            lens = lognormal(rng, w["last_exon"], 1)
        else:
            lens = np.concatenate([lognormal(rng, w["first_exon"], 1),
                                   lognormal(rng, w["internal_exon"],
                                             n_ex - 2),
                                   lognormal(rng, w["last_exon"], 1)])
        bases = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
        exons = np.split(bases, np.cumsum(lens)[:-1])
        want = int(min(rng.geometric(1.0 / tx_law["mean"]), tx_law["max"],
                       2 ** max(n_ex - 2, 0),
                       w["transcripts"] - len(seqs)))
        masks = []
        while len(masks) < want:
            keep = rng.random(n_ex) < w["keep_internal_exon"]
            keep[0] = keep[-1] = True
            m = int(np.dot(keep, 1 << np.arange(n_ex, dtype=np.int64)))
            if m not in masks:
                masks.append(m)
        for i, m in enumerate(masks):
            t = len(seqs)
            kept = [j for j in range(n_ex) if m >> j & 1]
            s, tail = with_tail(rng, np.concatenate([exons[j] for j in kept]),
                                w["min_len"])
            seg_txp += [t] * (len(kept) + (tail > 0))
            seg_exon += kept + [-1] * (tail > 0)
            seg_len += [int(lens[j]) for j in kept] + [tail] * (tail > 0)
            seqs.append(s)
            names.append(f"g{gene}.i{i}")
            gene_of.append(gene)
            mask_of.append(m)
        gene += 1
    structure = {
        "gene_of": np.array(gene_of, np.int32),
        "mask_of": np.array(mask_of, np.int64),
        "seg_txp": np.array(seg_txp, np.int32),
        "seg_exon": np.array(seg_exon, np.int32),
        "seg_len": np.array(seg_len, np.int64),
    }
    return names, seqs, structure


def single_exon(rng, w: dict):
    """`transcripts` unspliced genes, one transcript each, lengths by
    the `length` law, at least `min_len`."""
    lens = np.maximum(lognormal(rng, w["length"], w["transcripts"]),
                      w["min_len"])
    bases = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    seqs = np.split(bases, np.cumsum(lens)[:-1])
    return [f"t{i}" for i in range(len(seqs))], seqs, {}


GENERATORS = {"gene_structure": gene_structure, "single_exon": single_exon}


def make_world(cfg: dict) -> dict:
    """The configuration's world from its own seed: names, the
    concatenated codes (no separators), each transcript's start and
    length, and for a spliced world its structure."""
    w = dict(cfg["world"], transcripts=cfg["transcripts"])
    names, seqs, extra = GENERATORS[w["generator"]](
        np.random.default_rng(w["seed"]), w)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    offs = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return {"names": np.array(names), "concat": np.concatenate(seqs),
            "offs": offs, "lens": lens, **extra}


def load_world(cfg: dict, cache_dir: str) -> dict:
    """`make_world`, kept in `cache_dir/world.npz` after the first run."""
    path = os.path.join(cache_dir, "world.npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    world = make_world(cfg)
    os.makedirs(cache_dir, exist_ok=True)
    part = path + ".part.npz"
    np.savez(part, **world)
    os.replace(part, path)
    return world


def world_seqs(world: dict) -> list:
    """The transcripts as a list of code arrays (views)."""
    c, o = world["concat"], world["offs"]
    return [c[o[i]:o[i + 1]] for i in range(len(o) - 1)]


# ---------------------------------------------------------------- reads
def expression(lens: np.ndarray, law: dict):
    """Each transcript's share of the fragments under the abundance law,
    or None for a flat law (every transcript alike).  "flux": Flux
    Simulator's expression profile, molecules of the transcript at rank
    r (a permutation drawn from the law's own seed) in proportion to
    r^k exp(-(r / x1)(1 + r / x1)); a transcript's fragments in
    proportion to its molecules times its length."""
    if law["law"] == "flat":
        return None
    if law["law"] != "flux":
        raise ValueError(f"unknown abundance law {law['law']!r}")
    rank = np.random.default_rng(law["seed"]).permutation(len(lens)) + 1.0
    x = rank / law["x1"]
    w = rank ** law["k"] * np.exp(-x * (1.0 + x)) * lens
    return w / w.sum()


def draw_fragments(rng, lens, n: int, frag: dict, share=None):
    """The first draws of `simulate`: each fragment's transcript (by
    `share`, flat where None), start and length, (t, p, fl)."""
    t = (rng.integers(0, len(lens), n) if share is None
         else rng.choice(len(lens), n, p=share))
    if frag["law"] == "uniform":
        fl = rng.integers(frag["lo"], frag["hi"], n)
    elif frag["law"] == "normal":
        fl = np.clip(rng.normal(frag["mean"], frag["sd"], n).astype(np.int64),
                     frag["lo"], frag["hi"])
    else:
        raise ValueError(f"unknown fragment-length law {frag['law']!r}")
    fl = np.minimum(fl, lens[t])
    p = (rng.random(n) * (lens[t] - fl + 1)).astype(np.int64)
    return t, p, fl


def simulate(rng, concat, offs, lens, n: int, read_len: int, frag: dict,
             err: float, share=None):
    """n paired fragments: transcript by `share` (flat where None, as the
    port's bench draws it), fragment length by `frag`
    ({"law": "uniform", "lo", "hi"}: integers in [lo, hi), bench.py
    simulate_batches; {"law": "normal", "mean", "sd", "lo", "hi"}:
    N(mean, sd) truncated to an integer and clipped to [lo, hi],
    tools/bench_gencode.py simulate_batch), then clipped to the
    transcript; start uniform; mate 2 reverse-complemented;
    substitutions at rate `err`.  Returns (m1, m2, t, start, fl): the
    mates unpadded, each fragment's transcript, start in it and
    length."""
    t, p, fl = draw_fragments(rng, lens, n, frag, share)
    start = offs[t] + p
    win = np.lib.stride_tricks.sliding_window_view(concat, read_len)
    m1 = win[start]
    m2 = (3 - win[start + fl - read_len][:, ::-1]).astype(np.uint8)
    if err > 0:
        for m in (m1, m2):
            # the masked positions in row-major order, as m[mask] takes them
            idx = np.flatnonzero(rng.random(m.shape) < err)
            flat = m.reshape(-1)
            flat[idx] = (flat[idx] + rng.integers(1, 4, len(idx))) % 4
    return m1, m2, t, p, fl


def padded(m):
    """(n, read_len) codes -> (n, L) padded with code 4, L a multiple
    of 8 (the FASTQ reader's batch layout)."""
    L = (m.shape[1] + 7) // 8 * 8
    codes = np.full((m.shape[0], L), SEP, np.uint8)
    codes[:, :m.shape[1]] = m
    return codes
