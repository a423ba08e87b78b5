"""sailfish_tpu_torch — the PyTorch + CUDA port of sailfish_tpu.

The JAX package (``sailfish_tpu``) stays the reference; this package
re-implements its paired-end ``quant`` main path with torch tensors and
one hand-written CUDA kernel for NVIDIA Hopper (``csrc/mmp_scan.cu``):

  FASTQ batch -> oriented fwd/rc lanes (map/encode.py) -> MMP scan
  (map/scan.py, the CUDA kernel) -> intersect/dedupe/sort (map/postpass.py)
  -> mate merge + label collapse (map/pair.py) -> host eq-class
  accumulation (map/pipeline.py) -> FLD -> effective lengths -> EM
  (infer/em.py) -> quant.sf (quant.py, cli.py)

Host-side modules that never import jax (index builder, FASTQ reader,
eq-class containers, output writers, FLD statistics, library formats)
are imported from ``sailfish_tpu``; nothing in this package imports jax.
"""

__version__ = "0.1.0"
