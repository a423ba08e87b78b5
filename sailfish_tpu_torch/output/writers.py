"""Output serialization: quant.sf, aux dir, eq-class dump, bootstraps.

File formats match the reference GZipWriter (src/GZipWriter.cpp) so that
downstream consumers (e.g. tximport-style readers) can parse the output
unchanged:

  quant.sf                  TSV: Name Length EffectiveLength TPM NumReads
                            (TPM formula from :214-245)
  aux/meta_info.json        run stats (:163-190)
  aux/eq_classes.txt        numTxps, numClasses, names, then per-class
                            "size tid... count" (:51-92) — written under
                            the OUTPUT aux dir like the reference
  aux/fld.gz                gzipped raw int32 histogram (:140-143)
  aux/expected_bias.gz      gzipped raw float64 vector (:145-146)
  aux/observed_bias.gz      gzipped raw int32 vector (:148-152)
  aux/expected_gc.gz, aux/observed_gc.gz  same (:154-161)
  aux/bootstrap/names.tsv.gz   tab-separated transcript names (:114-136)
  aux/bootstrap/bootstraps.gz  concatenated raw float64 (bootstrap) or
                               int32 (gibbs) vectors (:250-284)
  cmd_info.json             invocation echo (SailfishQuantify.cpp:1263-1277)
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np

from .. import __version__
from ..eqclass.classes import EqClasses


def _fmt(x: float) -> str:
    """Format a double like C++ iostream/fmt default: up to 6 significant
    digits, shortest representation."""
    return f"{x:.6g}"


def write_quant_sf(
    path: str,
    names: list[str],
    ref_lens: np.ndarray,
    eff_lens: np.ndarray,
    est_counts: np.ndarray,
    num_mapped: float,
    use_eff_lens: bool = True,
) -> None:
    """quant.sf with the exact TPM formula of GZipWriter::writeAbundances
    (src/GZipWriter.cpp:214-245):

        npm_t   = count_t / numMapped
        tfrac_t = (npm_t / effLen_t) / sum_t' (npm_t' / effLen_t')
        TPM_t   = tfrac_t * 1e6
    """
    lens = np.asarray(ref_lens, dtype=np.float64)
    eff = np.asarray(eff_lens if use_eff_lens else ref_lens, dtype=np.float64)
    counts = np.asarray(est_counts, dtype=np.float64)
    npm = counts / num_mapped if num_mapped > 0 else np.zeros_like(counts)
    denom = float((npm / eff).sum())
    tpm = (npm / eff) / denom * 1e6 if denom > 0 else np.zeros_like(npm)
    with open(path, "w") as fh:
        fh.write("Name\tLength\tEffectiveLength\tTPM\tNumReads\n")
        for i, name in enumerate(names):
            fh.write(
                f"{name}\t{int(lens[i])}\t{_fmt(eff[i])}\t"
                f"{_fmt(tpm[i])}\t{_fmt(counts[i])}\n"
            )


def compute_tpm(
    eff_lens: np.ndarray, est_counts: np.ndarray, num_mapped: float
) -> np.ndarray:
    eff = np.asarray(eff_lens, dtype=np.float64)
    counts = np.asarray(est_counts, dtype=np.float64)
    npm = counts / num_mapped if num_mapped > 0 else np.zeros_like(counts)
    denom = float((npm / eff).sum())
    if denom <= 0:
        return np.zeros_like(npm)
    return (npm / eff) / denom * 1e6


def _write_gz_raw(path: str, arr: np.ndarray) -> None:
    with gzip.open(path, "wb", compresslevel=6) as fh:
        fh.write(np.ascontiguousarray(arr).tobytes())


class QuantWriter:
    def __init__(self, output_dir: str, aux_dir: str = "aux"):
        self.output_dir = output_dir
        self.aux_path = os.path.join(output_dir, aux_dir)
        os.makedirs(self.aux_path, exist_ok=True)
        self._bs_stream = None
        self._num_bootstraps_written = 0

    # ---- cmd_info.json (SailfishQuantify.cpp:1263-1277) ----
    def write_cmd_info(self, ordered_opts: list[tuple[str, object]]) -> None:
        doc: dict[str, object] = {"sf_version": __version__}
        for key, val in ordered_opts:
            doc[key] = val
        with open(os.path.join(self.output_dir, "cmd_info.json"), "w") as fh:
            json.dump(doc, fh, indent=4)

    # ---- quant.sf ----
    def write_abundances(
        self, names, ref_lens, eff_lens, est_counts, num_mapped,
        no_eff_length_correction: bool = False,
    ) -> None:
        write_quant_sf(
            os.path.join(self.output_dir, "quant.sf"),
            names, ref_lens, eff_lens, est_counts, num_mapped,
            use_eff_lens=not no_eff_length_correction,
        )

    # ---- lib_format_counts.json ----
    def write_lib_format_counts(
        self, expected_name: str, fmt_counts, num_compat: int,
        num_assigned: int, num_observed: int,
    ) -> None:
        """Observed-libtype accounting.  The reference declares the
        per-formatID counters (include/ReadLibrary.hpp:222-236) but
        Sailfish never feeds them; we count every mapped fragment's
        observed format (salmon-style lib_format_counts.json schema)."""
        from ..libformat import LibraryFormat

        counts = {}
        for fid, c in enumerate(fmt_counts):
            if c > 0:
                counts[LibraryFormat.from_id(fid).name] = int(c)
        doc = {
            "expected_format": expected_name,
            "compatible_fraction": (
                num_compat / num_assigned if num_assigned else 0.0
            ),
            "num_compatible_fragments": int(num_compat),
            "num_assigned_fragments": int(num_assigned),
            "num_processed_fragments": int(num_observed),
            "observed_formats": counts,
        }
        with open(
            os.path.join(self.output_dir, "lib_format_counts.json"), "w"
        ) as fh:
            json.dump(doc, fh, indent=4)

    # ---- eq-class dump (GZipWriter.cpp:51-92) ----
    def write_equiv_counts(self, names: list[str], eq: EqClasses) -> None:
        from ..eqclass.io import write_eq_dump

        write_eq_dump(
            os.path.join(self.aux_path, "eq_classes.txt"), names, eq,
            atomic=True,
        )

    # ---- aux/meta + distribution dumps (GZipWriter.cpp:101-192) ----
    def write_meta(
        self,
        *,
        names: list[str],
        fld_hist: np.ndarray,
        num_processed: int,
        num_mapped: int,
        num_bootstraps: int,
        num_gibbs_samples: int,
        bias_correct: bool,
        start_time: str,
        observed_seq_bias: np.ndarray | None = None,
        expected_seq_bias: np.ndarray | None = None,
        observed_gc: np.ndarray | None = None,
        expected_gc: np.ndarray | None = None,
        fld_realized: np.ndarray | None = None,
        timings: dict | None = None,
    ) -> None:
        num_samples = num_bootstraps if num_bootstraps > 0 else num_gibbs_samples
        if num_samples > 0:
            bs_dir = os.path.join(self.aux_path, "bootstrap")
            os.makedirs(bs_dir, exist_ok=True)
            with gzip.open(
                os.path.join(bs_dir, "names.tsv.gz"), "wb", compresslevel=6
            ) as fh:
                fh.write(("\t".join(names) + "\n").encode())

        # fld.gz: the realized histogram (int32), reference :140-143
        if fld_realized is None:
            fld_realized = np.asarray(fld_hist, dtype=np.int32)
        _write_gz_raw(
            os.path.join(self.aux_path, "fld.gz"),
            np.asarray(fld_realized, dtype=np.int32),
        )

        num_bias_bins = 4096  # 4^6, reference ReadKmerDist<6>
        if expected_seq_bias is None:
            expected_seq_bias = np.ones(num_bias_bins, dtype=np.float64)
        if observed_seq_bias is None:
            observed_seq_bias = np.ones(num_bias_bins, dtype=np.int32)
        if expected_gc is None:
            expected_gc = np.ones(101, dtype=np.float64)
        if observed_gc is None:
            observed_gc = np.zeros(101, dtype=np.int32)
        _write_gz_raw(
            os.path.join(self.aux_path, "expected_bias.gz"),
            np.asarray(expected_seq_bias, dtype=np.float64),
        )
        _write_gz_raw(
            os.path.join(self.aux_path, "observed_bias.gz"),
            np.asarray(observed_seq_bias, dtype=np.int32),
        )
        _write_gz_raw(
            os.path.join(self.aux_path, "expected_gc.gz"),
            np.asarray(expected_gc, dtype=np.float64),
        )
        _write_gz_raw(
            os.path.join(self.aux_path, "observed_gc.gz"),
            np.asarray(observed_gc, dtype=np.int32),
        )

        samp_type = "none"
        if num_bootstraps == 0 and num_samples > 0:
            samp_type = "gibbs"
        if num_bootstraps > 0:
            samp_type = "bootstrap"
        meta = {
            "sf_version": __version__,
            "samp_type": samp_type,
            "frag_dist_length": int(len(fld_hist) - 1 if len(fld_hist) else 0),
            "bias_correct": bool(bias_correct),
            "num_bias_bins": int(num_bias_bins),
            "num_targets": len(names),
            "num_bootstraps": int(num_bootstraps),
            "num_processed": int(num_processed),
            "num_mapped": int(num_mapped),
            "percent_mapped": (
                100.0 * num_mapped / num_processed if num_processed else 0.0
            ),
            "call": "quant",
            "start_time": start_time,
        }
        if timings is not None:
            # per-phase breakdown (extension beyond the reference's meta)
            meta["quant_timings"] = timings
        with open(os.path.join(self.aux_path, "meta_info.json"), "w") as fh:
            json.dump(meta, fh, indent=4)

    # ---- bootstraps (GZipWriter.cpp:250-284) ----
    def write_bootstrap(self, abund: np.ndarray) -> None:
        if self._bs_stream is None:
            bs_dir = os.path.join(self.aux_path, "bootstrap")
            os.makedirs(bs_dir, exist_ok=True)
            self._bs_stream = gzip.open(
                os.path.join(bs_dir, "bootstraps.gz"), "wb", compresslevel=6
            )
        self._bs_stream.write(np.ascontiguousarray(abund).tobytes())
        self._num_bootstraps_written += 1

    def close(self) -> None:
        if self._bs_stream is not None:
            self._bs_stream.close()
            self._bs_stream = None
