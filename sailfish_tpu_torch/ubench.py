"""Op-chain microbenchmark: ``python -m sailfish_tpu_torch.ubench``.

Counterpart of tools/ubench_pallas.py.  For a variant, a start value, an
iteration count and the buffers, the kernel (csrc/ubench.cu, one warp)
runs `iters` dependent iterations of the variant's op chain and returns
the int32 accumulator; the caller times it and prints ns per iteration.
The 14 variants of the TPU tool keep their names and chain, on a Hopper
card, the work that stands in the same place in the scan kernel
(csrc/mmp_scan.cu); `bucket64`, `sa_window` and `text_read` time the
scan's three dependent global loads.

`ubench_cuda` launches the kernel on CUDA tensors; `ubench_reference` is
the plain version (torch ops on CPU tensors in a Python loop, meant for a
few thousand iterations).  A CUDA tensor never reaches the plain version,
the kernel has no CPU mode, and a build or launch failure raises.

Per iteration, with acc the int32 accumulator (all arithmetic wraps),
ua its bits as uint32, tt = ua & 7 and t the thread (0..31):

  empty        acc += 1
  roll16x4     the (16, 32) tile rotated left by tt four times along the
               warp; acc += sum of column 0
  roll1x4      the same for pair[0:32], one row
  store6       three times: pair[0:32], pair[32:64] = tile rows (j + tt)
               & 15 and (j + 1 + tt) & 15; acc += pair[0]
  alignchain   lo = min(mix(ua, 0x9E3779B9) & (n_sa - 1), n_sa - 32);
               thread t walks the text from sa[lo + ((t + tt) & 31)]
               against the read; acc += longest walk + 1
  lcp          first column c >= ua & 63 of al (8, 64) where some row
               differs from row 0, else 64; acc += c + 1
  when8_true   for j < 8: if acc >= j, pair[j] = j; acc += 1
  when8_false  for j < 8: if acc < -j - 1, pair[j] = j; acc += 1
  when8_smem   for j < 8: if acc >= j, scal = acc + j; acc += 1
  select8      v = acc; for j < 8: v += j if acc >= j; scal = v; acc += 1
  while0       a loop of no trips while acc >= 0 (one trip, acc += 1,
               when acc < 0); acc += 1
  smem16       v = acc; 16 times v += xs[v & 15]; acc = v + 1
  dma16        copy hbm rows [r, r + 16), r = (ua & 1023) * 8, to shared
               memory, wait; acc += 1 + first copied word
  dma16x4      four such copies in flight, r_j = ((ua + 997 j) & 1023)
               * 8, wait for all; acc += 1 + their four first words
  bucket64     row = mix(ua, 0x85EBCA77) & (S - 1) of the (S, 16) table,
               64 bytes; acc += 1 + ((row[0] ^ row[5] ^ row[10] ^
               row[15]) & 0xFFFF)
  sa_window    lo = min(mix(ua, 0xC2B2AE3D) & (n_sa - 1), n_sa - 64);
               acc += 1 + (sum over t of sa[lo + t] ^ sa[lo + 32 + t])
               & 0xFFFF
  text_read    thread t walks the text from period mix(ua + t *
               0x85EBCA77, 0x9E3779B9) & (P - 1); acc += longest walk + 1

`mix` is the k-mer table's hash (bits.mix_kmer).  With acc = 0 at the
start and all-zero buffers, empty, when8_true, when8_false, when8_smem,
select8, while0, smem16, dma16 and dma16x4 return `iters` — the values
the TPU tool's kernel is defined for.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from .bits import M32
from .device import as_device

VARIANTS = (
    "empty", "roll16x4", "roll1x4", "store6", "alignchain", "lcp",
    "when8_true", "when8_false", "when8_smem", "select8", "while0",
    "smem16", "dma16", "dma16x4", "bucket64", "sa_window", "text_read",
)
HBM_ROWS = 1024 * 8 + 16        # rows of 128 int32, as the TPU tool's
PERIOD = 128                    # bytes per text period
# name -> (dtype, fixed shape or None)
_BUFFERS = {
    "xs": (torch.int32, (16,)),
    "tile": (torch.int32, (16, 32)),
    "pair": (torch.int32, (64,)),
    "al": (torch.int32, (8, 64)),
    "hbm": (torch.int32, (HBM_ROWS, 128)),
    "table": (torch.int32, None),     # (2^b, 16)
    "sa": (torch.int32, None),        # (2^b,), b >= 6
    "text": (torch.uint8, None),      # ((2^b + 1) * PERIOD,)
    "read": (torch.uint8, None),      # (n,), n <= PERIOD
}


def make_buffers(seed: int, *, table_bits: int = 21, sa_bits: int = 25,
                 period_bits: int = 20, read_len: int = 100,
                 device="cpu") -> dict:
    """The benchmark's buffers from a seed, non-zero so that every step
    moves the accumulator.  The defaults give a 128 MB table, a 128 MB
    suffix array and a 128 MB text, each larger than the card's L2.

    The text repeats one random 128-base period with a substitution at
    every 16th base on average; the read is the period's first
    `read_len` bases and every suffix-array entry is a period start, so
    a walk runs until the first substitution.  The rows of `al` equal
    row 0 except in one column of eight on average, so `lcp` searches.
    Made on the CPU (one
    generator, one stream of numbers) and moved to `device`."""
    if not (6 <= sa_bits <= 30 and 0 <= table_bits <= 26
            and 0 <= period_bits <= 23 and 1 <= read_len <= PERIOD):
        raise ValueError("buffer sizes out of range")
    g = torch.Generator().manual_seed(seed)

    def ints(shape, lo=1, hi=2**20):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    periods = 2**period_bits + 1
    base = torch.randint(0, 4, (PERIOD,), generator=g, dtype=torch.uint8)
    text = base.repeat(periods)
    hit = torch.rand(text.shape, generator=g) < 1 / 16
    shift = torch.randint(1, 4, (int(hit.sum()),), generator=g,
                          dtype=torch.uint8)
    text[hit] = (text[hit] + shift) % 4
    al = ints((1, 64)).repeat(8, 1)
    cols = (torch.rand(64, generator=g) < 1 / 8).nonzero()[:, 0]
    rows = torch.randint(1, 8, (cols.numel(),), generator=g)
    al[rows, cols] += 1
    bufs = {
        "xs": ints((16,)),
        "tile": ints((16, 32)),
        "pair": ints((64,)),
        "al": al,
        "hbm": ints((HBM_ROWS, 128)),
        "table": ints((2**table_bits, 16)),
        "sa": PERIOD * torch.randint(0, 2**period_bits, (2**sa_bits,),
                                     generator=g, dtype=torch.int32),
        "text": text,
        "read": base[:read_len].clone(),
    }
    dev = as_device(device)
    return {k: v.to(dev) for k, v in bufs.items()}


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two (got {n})")
    return n.bit_length() - 1


def _check(variant: str, iters: int, x0: int, bufs: dict, dev_type: str):
    """Validate a call; returns (table_bits, sa_bits, period_bits)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (one of {VARIANTS})")
    if not (0 <= iters < 2**31 and -2**31 <= x0 < 2**31):
        raise ValueError("iters and x0 must fit int32, iters >= 0")
    if set(bufs) != set(_BUFFERS):
        raise ValueError(f"buffers must be exactly {sorted(_BUFFERS)}")
    for name, (dtype, shape) in _BUFFERS.items():
        t = bufs[name]
        if t.device.type != dev_type:
            raise ValueError(f"buffer {name} is on {t.device}, not on a "
                             f"{dev_type} device")
        if t.dtype != dtype or not t.is_contiguous() \
                or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"buffer {name}: need contiguous {dtype} "
                             f"{shape or ''}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    table, sa, text, read = (bufs[k] for k in ("table", "sa", "text", "read"))
    if table.dim() != 2 or table.shape[1] != 16 or sa.dim() != 1 \
            or text.dim() != 1 or read.dim() != 1:
        raise ValueError("table (S, 16), sa (n,), text (m,), read (r,)")
    if text.numel() % PERIOD or not 1 <= read.numel() <= PERIOD:
        raise ValueError("text must be whole periods, read at most one")
    bits = (_log2(table.shape[0], "table rows"),
            _log2(sa.numel(), "suffix-array length"),
            _log2(text.numel() // PERIOD - 1, "text periods less one"))
    if bits[1] < 6:
        raise ValueError("the suffix array needs at least 64 entries")
    return bits


def ubench_cuda(variant: str, iters: int, x0: int, bufs: dict,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch csrc/ubench.cu on the current stream of the buffers' CUDA
    device; returns the accumulator as a 1-element int32 tensor on that
    device without waiting for it (`.item()` waits).  The suffix-array
    entries must be period starts inside the text (as `make_buffers`
    makes them).  `ubench_cuda.launches` counts successful launches."""
    from . import _ext

    tb, sb, pb = _check(variant, iters, x0, bufs, "cuda")
    dev = bufs["xs"].device
    if any(t.device != dev for t in bufs.values()):
        raise ValueError("buffers lie on different devices")
    if out is None:
        out = torch.empty(1, dtype=torch.int32, device=dev)
    elif out.device != dev or out.dtype != torch.int32 or out.numel() != 1:
        raise ValueError("out must be one int32 on the buffers' device")
    kl = _ext.load()
    err = kl.lib.sf_ubench(
        VARIANTS.index(variant), iters, x0, bufs["xs"].data_ptr(),
        bufs["tile"].data_ptr(), bufs["pair"].data_ptr(),
        bufs["al"].data_ptr(), bufs["hbm"].data_ptr(),
        bufs["table"].data_ptr(), tb, bufs["sa"].data_ptr(), sb,
        bufs["text"].data_ptr(), pb, bufs["read"].data_ptr(),
        bufs["read"].numel(), out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    kl.check(err, f"ubench kernel launch ({variant})")
    ubench_cuda.launches += 1
    return out


ubench_cuda.launches = 0


def _wrap(v: int) -> int:
    """Python int -> the int32 with the same low 32 bits."""
    v &= M32
    return v - 2**32 if v >= 2**31 else v


def _mix(k0: int, k1: int) -> int:
    """bits.mix_kmer on Python ints."""
    h = ((k0 * 0x9E3779B1) ^ (k1 * 0x85EBCA77)) & M32
    h ^= h >> 15
    h = (h * 0xC2B2AE3D) & M32
    return h ^ (h >> 13)


def _walks(bufs: dict, g: torch.Tensor) -> int:
    """Longest walk of the 32 threads: text from g[t] against the read,
    until a mismatch, an N (code > 3) or the read end."""
    read = bufs["read"]
    j = torch.arange(read.numel())
    ok = (read[None, :] < 4) & (bufs["text"][g[:, None] + j[None, :]]
                                == read[None, :])
    return int(ok.to(torch.int32).cumprod(dim=1).sum(dim=1).max())


def ubench_reference(variant: str, iters: int, x0: int, bufs: dict) -> int:
    """Plain version of the kernel: the accumulator after `iters`
    iterations, as a Python int in int32 range.  CPU tensors only."""
    _, sb, pb = _check(variant, iters, x0, bufs, "cpu")
    tile = bufs["tile"].clone()
    pair = bufs["pair"].clone()
    al, xs, hbm = bufs["al"], bufs["xs"], bufs["hbm"]
    table, sa = bufs["table"], bufs["sa"]
    n_sa = 1 << sb
    lanes = torch.arange(32)
    acc = _wrap(x0)
    for _ in range(iters):
        ua = acc & M32
        tt = ua & 7
        if variant == "empty":
            d = 1
        elif variant == "roll16x4":
            r = tile
            for _k in range(4):
                r = torch.roll(r, -tt, dims=1)
            d = int(r[:, 0].sum())
        elif variant == "roll1x4":
            r = pair[:32]
            for _k in range(4):
                r = torch.roll(r, -tt, dims=0)
            d = int(r[0])
        elif variant == "store6":
            for j in range(3):
                pair[:32] = tile[(j + tt) & 15]
                pair[32:] = tile[(j + 1 + tt) & 15]
            d = int(pair[0])
        elif variant == "alignchain":
            lo = min(_mix(ua, 0x9E3779B9) & (n_sa - 1), n_sa - 32)
            g = sa[lo + ((lanes + tt) & 31)].long()
            d = _walks(bufs, g) + 1
        elif variant == "lcp":
            neq = (al != al[0:1]).any(dim=0)
            col = torch.arange(64)
            cand = torch.where(neq & (col >= (ua & 63)), col, 64)
            d = int(cand.min()) + 1
        elif variant in ("when8_true", "when8_false"):
            for j in range(8):
                if (acc >= j) if variant == "when8_true" else (acc < -j - 1):
                    pair[j] = j
            d = 1
        elif variant in ("when8_smem", "select8"):
            # their stores and selects end in the scratch word `scal`,
            # which no variant reads back
            d = 1
        elif variant == "while0":
            d = 2 if acc < 0 else 1
        elif variant == "smem16":
            v = acc
            for _k in range(16):
                v = _wrap(v + int(xs[v & 15]))
            d = _wrap(v + 1 - acc)
        elif variant == "dma16":
            d = 1 + int(hbm[(ua & 1023) * 8, 0])
        elif variant == "dma16x4":
            d = 1 + sum(int(hbm[((ua + 997 * j) & 1023) * 8, 0])
                        for j in range(4))
        elif variant == "bucket64":
            row = table[_mix(ua, 0x85EBCA77) & (table.shape[0] - 1)]
            d = 1 + (int(row[0] ^ row[5] ^ row[10] ^ row[15]) & 0xFFFF)
        elif variant == "sa_window":
            lo = min(_mix(ua, 0xC2B2AE3D) & (n_sa - 1), n_sa - 64)
            w = sa[lo:lo + 64].long() & M32
            d = 1 + (int((w[:32] ^ w[32:]).sum()) & 0xFFFF)
        else:  # text_read
            g = torch.tensor([
                PERIOD * (_mix((ua + t * 0x85EBCA77) & M32, 0x9E3779B9)
                          & ((1 << pb) - 1)) for t in range(32)])
            d = _walks(bufs, g) + 1
        acc = _wrap(acc + d)
    return acc


def time_variant(variant: str, iters: int, x0: int, bufs: dict,
                 reps: int = 3) -> float:
    """Best of `reps` timed launches after one warm launch, in ns per
    iteration (CUDA events around each launch)."""
    out = torch.empty(1, dtype=torch.int32, device=bufs["xs"].device)
    ubench_cuda(variant, iters, x0, bufs, out)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ubench_cuda(variant, iters, x0, bufs, out)
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best * 1e6 / max(iters, 1)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="sailfish_tpu_torch.ubench",
        description="time each op-chain variant on the CUDA card "
                    "(ns per iteration, best of 3 after one warm run)")
    ap.add_argument("--iters", type=int, default=100_000,
                    help="dependent iterations per launch")
    args = ap.parse_args(argv)
    dev = as_device("cuda")     # the kernel has no CPU mode
    bufs = make_buffers(0, device=dev)
    print(f"# {card_line()} | {args.iters} iterations", flush=True)
    for variant in VARIANTS:
        ns = time_variant(variant, args.iters, 0, bufs)
        print(f"{variant:12s} {ns:8.1f} ns/iter", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
