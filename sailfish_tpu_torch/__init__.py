"""sailfish_tpu_torch — the PyTorch + CUDA port of sailfish_tpu.

The JAX package (``sailfish_tpu``) stays the reference; this package
re-implements its ``quant`` main path (one paired-end or single-end
library, reads of any length) with torch tensors and a hand-written CUDA
kernel for NVIDIA Hopper (``csrc/mmp_scan.cu``), and its op-chain
microbenchmark tool (``ubench.py``, ``csrc/ubench.cu``):

  FASTQ batch -> oriented fwd/rc lanes (map/encode.py) -> MMP scan
  (map/scan.py, the CUDA kernel) -> intersect/dedupe/sort (map/postpass.py)
  -> mate merge + label collapse (map/pair.py) -> host eq-class
  accumulation (map/pipeline.py) -> FLD -> effective lengths -> EM
  (infer/em.py) -> quant.sf (quant.py, cli.py)

The host side (index build and load, FASTQ reader, eq-class containers,
output writers, FLD statistics, library formats, the numpy reference
mapper) is this package's own, each module at its counterpart's path;
nothing here imports jax or ``sailfish_tpu``.
"""

__version__ = "0.1.0"

# Version of the on-disk index layout; equal to sailfish_tpu's, whose
# index directories this package reads and writes.
INDEX_VERSION = 3
