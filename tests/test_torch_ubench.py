"""The plain version of the op-chain microbenchmark (sailfish_tpu_torch/
ubench.py).  The kernel itself (csrc/ubench.cu) runs on a CUDA card only
and is held against this plain version there, by chip_smoke.py.

No call into the JAX package is made: its kernel is a closure inside
tools/ubench_pallas.py `main()`, which runs on a TPU only (pltpu.roll,
SMEM block specs, DMA semaphores, no interpret mode).  What that kernel
defines is checked instead: with the tool's inputs (x = 0, all-zero
buffers) nine variants return the iteration count; the others add
uninitialised scratch memory there and have no defined value."""

import subprocess
import sys

import pytest
import torch

from sailfish_tpu_torch import ubench
from torch_port import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(table_bits=8, sa_bits=8, period_bits=4)
DEFINED = ("empty", "when8_true", "when8_false", "when8_smem", "select8",
           "while0", "smem16", "dma16", "dma16x4")
# variants whose chain reads no buffer: closed form for any buffers
CONTROL_ONLY = ("empty", "when8_true", "when8_false", "when8_smem",
                "select8", "while0")


@pytest.fixture(scope="module")
def bufs():
    return ubench.make_buffers(1, **SMALL)


def test_the_tool_has_the_17_variants():
    assert len(ubench.VARIANTS) == len(set(ubench.VARIANTS)) == 17
    assert set(DEFINED) < set(ubench.VARIANTS)
    assert ubench.VARIANTS[-3:] == ("bucket64", "sa_window", "text_read")


@pytest.mark.parametrize("variant", DEFINED)
def test_defined_variants_return_the_iteration_count(bufs, variant):
    zero = {k: torch.zeros_like(v) for k, v in bufs.items()}
    for iters in (0, 1, 257):
        assert ubench.ubench_reference(variant, iters, 0, zero) == iters


@pytest.mark.parametrize("variant", ubench.VARIANTS)
def test_result_depends_on_the_buffers(bufs, variant):
    """No dead chain in the plain version: another seed's buffers give
    another accumulator, for every variant that reads a buffer; the
    control-only variants give x0 + iters whatever the buffers hold."""
    other = ubench.make_buffers(2, **SMALL)
    a = ubench.ubench_reference(variant, 64, 5, bufs)
    b = ubench.ubench_reference(variant, 64, 5, other)
    if variant in CONTROL_ONLY:
        assert a == b == 69
    else:
        assert a != b
        # and on every step: one more iteration moves it again
        assert ubench.ubench_reference(variant, 65, 5, bufs) != a


# with every word of a buffer equal to 3, what one iteration adds:
# worked out by hand from the chains in the module's docstring
CONSTANT = {
    "roll16x4": 16 * 3,         # column 0 of 16 rows, whatever the rotation
    "roll1x4": 3,
    "store6": 3,                # pair[0] is a tile word after the stores
    "lcp": 64 + 1,              # no row differs from row 0
    "smem16": 16 * 3 + 1,
    "dma16": 1 + 3,
    "dma16x4": 1 + 4 * 3,
    "bucket64": 1,              # the four words cancel in the xor
    "sa_window": 1,             # so do the window's two halves
}


@pytest.mark.parametrize("variant", sorted(CONSTANT))
def test_closed_forms_on_constant_buffers(bufs, variant):
    """Independent of the closed form `iters`: buffers of one repeated
    value give each buffer-reading chain a sum that can be written down,
    from any start value."""
    const = {k: torch.full_like(v, 3) for k, v in bufs.items()}
    const["sa"] = torch.zeros_like(bufs["sa"])
    for iters, x0 in ((1, 0), (33, 7), (100, -50)):
        assert ubench.ubench_reference(variant, iters, x0, const) \
            == x0 + iters * CONSTANT[variant]


def test_deterministic_from_a_seed(bufs):
    again = ubench.make_buffers(1, **SMALL)
    assert set(again) == set(bufs)
    for k in bufs:
        assert torch.equal(again[k], bufs[k]), k
    for k in ("xs", "tile", "pair", "al", "hbm", "table"):
        assert int(bufs[k].min()) > 0, k          # non-zero data
    for v in ("roll16x4", "alignchain", "dma16x4", "text_read"):
        assert ubench.ubench_reference(v, 40, 0, bufs) \
            == ubench.ubench_reference(v, 40, 0, again)


def test_arithmetic_wraps_like_int32(bufs):
    top = 2**31 - 1
    assert ubench.ubench_reference("empty", 3, top, bufs) == -2**31 + 2
    assert ubench.ubench_reference("while0", 2, -5, bufs) == -1
    for v in ubench.VARIANTS:
        r = ubench.ubench_reference(v, 8, top - 3, bufs)
        assert -2**31 <= r < 2**31, v


def test_walk_variants_follow_the_text(bufs):
    """alignchain and text_read add the longest walk plus one: with the
    read equal to every text period (no substitutions) each iteration
    adds read_len + 1."""
    clean = dict(bufs)
    period = bufs["text"][:ubench.PERIOD]
    clean["text"] = period.repeat(bufs["text"].numel() // ubench.PERIOD)
    clean["read"] = period[:100].clone()
    for v in ("alignchain", "text_read"):
        assert ubench.ubench_reference(v, 7, 0, clean) == 7 * 101
    n_read = clean["read"].clone()
    n_read[10] = 4                                # an N ends a walk
    clean["read"] = n_read
    assert ubench.ubench_reference("text_read", 7, 0, clean) == 7 * 11


def test_bad_calls_raise(bufs):
    with pytest.raises(ValueError, match="unknown variant"):
        ubench.ubench_reference("roll2", 1, 0, bufs)
    with pytest.raises(ValueError, match="power of two"):
        ubench.ubench_reference(
            "empty", 1, 0, {**bufs, "table": bufs["table"][:100]})
    with pytest.raises(ValueError, match="buffer pair"):
        ubench.ubench_reference(
            "empty", 1, 0, {**bufs, "pair": bufs["pair"].long()})
    with pytest.raises(ValueError, match="exactly"):
        ubench.ubench_reference("empty", 1, 0, {"xs": bufs["xs"]})
    with pytest.raises(ValueError):
        ubench.ubench_reference("empty", -1, 0, bufs)
    # the kernel has no CPU mode, and the plain version takes no CUDA
    # tensor: CPU buffers never reach a launch
    before = ubench.ubench_cuda.launches
    with pytest.raises(ValueError, match="not on a cuda device"):
        ubench.ubench_cuda("empty", 1, 0, bufs)
    assert ubench.ubench_cuda.launches == before


def test_entry_point_needs_the_card_and_import_builds_nothing():
    """`python -m sailfish_tpu_torch.ubench` has no CPU mode: without a
    card it fails with device.py as_device's message; importing the
    module compiles nothing."""
    probe = ("import sailfish_tpu_torch.ubench as u, sailfish_tpu_torch._ext"
             " as e, torch; assert e._LOADED is None; "
             "print(torch.cuda.is_available()); "
             "raise SystemExit(u.main(['--iters', '10']))")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=300)
    if proc.stdout.startswith("True"):
        pytest.skip("this machine has a CUDA card: the entry point runs")
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
