"""The host side the port shares with the JAX package.

The port reuses sailfish_tpu's jax-free host modules instead of copying
them: index build and load, options, FASTQ reading, library formats,
eq-class accumulation and dump, FLD statistics, output writers, the
CLI's argument parsers and the numpy reference mapper (the correctness
oracle behind `--backend refimpl`).  This module is the one place the
port imports them from, so callers of the port (tests, chip_smoke.py)
need no import of sailfish_tpu either.  None of them imports jax
(tests/test_torch_package.py checks both).
"""

from __future__ import annotations

from sailfish_tpu.cli import (  # noqa: F401
    _add_index_parser,
    _add_quant_parser,
    _flatten_read_args,
    _setup_logging,
)
from sailfish_tpu.config import QuantOpts  # noqa: F401
from sailfish_tpu.eqclass.classes import (  # noqa: F401
    EqClassAccumulator,
    EqClasses,
    HashedEqClassAccumulator,
)
from sailfish_tpu.eqclass.io import read_eq_classes  # noqa: F401
from sailfish_tpu.index.builder import (  # noqa: F401
    QuasiIndex,
    build_index_from_fasta,
    load_index,
    save_index,
)
from sailfish_tpu.io.fastq import (  # noqa: F401
    FastqBatch,
    _iter_fastq_seq_blocks,
    iter_paired_fastq_batches,
)
from sailfish_tpu.io.native import _lib as _native_lib
from sailfish_tpu.libformat import (  # noqa: F401
    LibraryFormat,
    MateStatus,
    ReadType,
    compatible_hit_single,
    parse_library_format,
)
from sailfish_tpu.output.genemap import (  # noqa: F401
    generate_gene_level_estimates,
)
from sailfish_tpu.output.writers import QuantWriter  # noqa: F401
from sailfish_tpu.refimpl.mapper import RefMapper  # noqa: F401
from sailfish_tpu.stats.fld import (  # noqa: F401
    EmpiricalDistribution,
    effective_lengths_from_fld,
)


def native_sais_available() -> bool:
    """Whether `index` builds the suffix array with the native SA-IS
    library (sailfish_tpu/_native.so) rather than the numpy fallback."""
    lib = _native_lib()
    return lib is not None and hasattr(lib, "sf_build_sa")
