"""Run configuration — the analog of the reference's flat options struct
(include/SailfishOpts.hpp:9-41) plus the device path's capacities.

Counterpart of sailfish_tpu/config.py.  The TPU path's kernel choice and
fast-path tuning knobs (`kernel`, `escalation_backend`, `xscan_*`, ...)
have no field here: the CLI accepts their flags and ignores them, since
by their contracts they change no output.  The fields the port acts on
are validated at construction.

Defaults mirror the reference CLI defaults
(src/SailfishQuantify.cpp:1066-1153)."""

from __future__ import annotations

from dataclasses import dataclass, field

MMP_SKIP_RULES = ("nip", "jump")
EM_DTYPES = ("float32", "float64")


@dataclass
class QuantOpts:
    # --- paths ---
    index_dir: str = ""
    output_dir: str = ""
    aux_dir: str = "aux"

    # --- library ---
    lib_type: str = "IU"
    mates1: list[str] = field(default_factory=list)
    mates2: list[str] = field(default_factory=list)
    unmated_reads: list[str] = field(default_factory=list)
    # ordered multi-library runs (reference extractReadLibraries,
    # src/SailfishUtils.cpp:103-153): each entry is a dict with keys
    # {"fmt", "m1", "m2", "um"}.  Empty = single library synthesized
    # from lib_type/mates1/mates2/unmated_reads above.
    libraries: list = field(default_factory=list)

    # --- mapping ---
    max_read_occs: int = 200       # --maxReadOcc (:1143)
    strict_intersect: bool = False  # --strictIntersect (:1105)
    allow_dovetail: bool = False    # --allowDovetail (:1125)
    allow_orphans: bool = True      # negated --discardOrphans (:1128)
    ignore_lib_compat: bool = False  # --ignoreLibCompat (:1119)
    enforce_lib_compat: bool = False  # --enforceLibCompat (:1121)

    # --- fragment length distribution ---
    max_frag_len: int = 1000       # --maxFragLen (:1112)
    num_frag_samples: int = 10000  # --numFragSamples (:1133)
    fld_mean: int = 200            # --fldMean (:1136)
    fld_sd: int = 80               # --fldSD (:1140)
    use_unsmoothed_fld: bool = False  # --unsmoothedFLD (:1109)
    no_effective_length_correction: bool = False  # (:1144)

    # --- bias ---
    bias_correct: bool = False     # --biasCorrect (:1089)
    gc_bias_correct: bool = False  # --gcBiasCorrect (:1090)
    num_bias_samples: int = 1000000  # --numBiasSamples (:1131)
    gc_samp_factor: int = 1        # --gcSizeSamp (:1101)
    pdf_samp_factor: int = 1       # --gcSpeedSamp (:1103)

    # --- inference ---
    use_vb_opt: bool = False       # --useVBOpt (:1148)
    num_gibbs_samples: int = 0     # --numGibbsSamples (:1150)
    num_bootstraps: int = 0        # --numBootstraps (:1152)
    em_tolerance: float = 0.01     # optimize(..., 0.01, 10000) (:1343)
    em_max_iter: int = 10000
    seed: int = 0                  # PRNG seed for samplers (deterministic
                                   # given the seed; the reference used
                                   # std::random_device)

    # --- outputs / resume ---
    dump_eq: bool = False          # --dumpEq (:1099)
    checkpoint_interval: int = 0   # fragments between streaming eq-class
    #                                checkpoints (0 = off); resume with
    #                                --resumeFromEq
    resume_from_eq: str = ""       # path to an eq_classes.txt dump (or a
                                   # quant output dir containing one):
                                   # skip mapping and re-run inference +
                                   # outputs from the checkpoint
    gene_map: str = ""             # --geneMap (:1081)
    txp_aggregation_key: str = "gene_id"  # --txpAggregationKey (:1115)

    # --- execution ---
    batch_size: int = 65536        # reads per device batch
    num_threads: int = 4           # host-side IO / decode workers
    num_shards: int = 1            # multi-host DP: total read shards
    shard_id: int = 0              # this host's shard (round-robin
    #                                over batches; combine via mergeeq)
    map_only: bool = False         # stop after mapping: write eq dump +
    #                                quant state, skip inference/outputs
    #                                (the per-shard half of a multi-host
    #                                run; see parallel/launcher.py)
    max_mmps: int = 4              # max MMP seeds recorded per read per
                                   # orientation (static capacity)
    max_scan_steps: int = 0        # max sequential seed-probe positions
                                   # per oriented read; 0 = auto (full
                                   # scan to the read end, the reference
                                   # semantics — RapMap bounds scanning
                                   # only by the read length).  Each
                                   # probed position (hit OR miss)
                                   # consumes one step in every backend.
    scan_shrink: int = 1           # >1 (compacted scan steps, a lossy
                                   # mode of the JAX package) is refused
                                   # by quant.check_slice
    mmp_skip: str = "nip"          # after an MMP of length l at position
                                   # i: "nip" -> i+max(1, l-k+1) (the
                                   # RapMap SACollector overlap re-probe
                                   # — DEFAULT, matches the reference's
                                   # hit sets; catches cross-transcript
                                   # hits in windows spanning the
                                   # mismatch), "jump" -> i+l+1 (just
                                   # past the mismatch; ~errors+1 steps,
                                   # faster but provably diverges on
                                   # error-bearing reads — see
                                   # FIDELITY.md)
    hit_capacity: int = 64         # max candidate loci per read per
                                   # orientation (static capacity); reads
                                   # exceeding it are treated like
                                   # > max_read_occs and dropped
    hit_capacity_max: int = 0      # escalation capacity: fragments whose
                                   # kernel pass overflows hit_capacity
                                   # are gathered and re-mapped through a
                                   # wide second pass of the same kernel
                                   # at this capacity (0 = no escalation).
                                   # Set >= max_read_occs to honor the
                                   # full --maxReadOcc envelope on
                                   # repetitive references
                                   # (map/pipeline.py finish_batch*).
    dtype: str = "float64"         # EM dtype ("float32" or "float64")

    def __post_init__(self):
        if self.mmp_skip not in MMP_SKIP_RULES:
            raise ValueError(f"unknown mmp_skip rule: {self.mmp_skip!r} "
                             f"(one of {MMP_SKIP_RULES})")
        if self.dtype not in EM_DTYPES:
            raise ValueError(f"unknown EM dtype: {self.dtype!r} "
                             f"(one of {EM_DTYPES})")
        for name, floor in (("max_read_occs", 0), ("hit_capacity", 1),
                            ("hit_capacity_max", 0), ("max_mmps", 1),
                            ("max_scan_steps", 0), ("batch_size", 1),
                            ("max_frag_len", 1), ("num_frag_samples", 0)):
            if getattr(self, name) < floor:
                raise ValueError(
                    f"{name} must be >= {floor} (got {getattr(self, name)})")

    def effective_scan_steps(self, window_len: int) -> int:
        """The per-oriented-read probe-position budget: the configured
        cap, or (auto, the default) enough steps to scan to the read
        end — probes advance >= 1 position each, so window - k + 1 steps
        can never bind before the read end does (reference parity:
        RapMap bounds scanning only by read length)."""
        if self.max_scan_steps > 0:
            return self.max_scan_steps
        return max(window_len, 1)

    def effective_hit_capacity(self) -> int:
        """The per-probe candidate envelope the device path honors (the
        escalation capacity when enabled); the numpy oracle applies the
        same cap so device and oracle agree across the boundary."""
        return max(self.hit_capacity, self.hit_capacity_max)

    def read_libraries(self) -> list:
        """Normalized ordered read libraries.  Multi-library runs carry
        them in `libraries`; otherwise one library is synthesized from
        lib_type/mates1/mates2/unmated_reads (the single-`-l` form)."""
        if self.libraries:
            return [dict(lib) for lib in self.libraries]
        return [{
            "fmt": self.lib_type,
            "m1": list(self.mates1),
            "m2": list(self.mates2),
            "um": list(self.unmated_reads),
        }]


@dataclass
class IndexOpts:
    transcripts_fasta: str = ""
    out_dir: str = ""
    k: int = 31                    # index k-mer length; must be odd and
                                   # < 32 (reference SailfishIndexer.cpp:199-205
                                   # requires odd k <= 31)
    prefix_bits: int = 0           # log4 size of the k-mer prefix lookup
                                   # table; 0 = auto from text size
    force: bool = False
