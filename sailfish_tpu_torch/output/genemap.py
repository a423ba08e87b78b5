"""Transcript-to-gene mapping and gene-level aggregation.

Re-implements:
  * TranscriptGeneMap (reference include/TranscriptGeneMap.hpp:35-148)
  * transcriptGeneMapFromGTF — GTF parsing via libgff in the reference
    (src/SailfishUtils.cpp:322-435); here a small pure-Python GTF
    attribute parser
  * readTranscriptToGeneMap — 2-column TSV (:438-506)
  * aggregateEstimatesToGeneLevel / generateGeneLevelEstimates
    (:929-1088): re-parses the WRITTEN quant.sf (not in-memory state),
    sums TPM/NumReads per gene, TPM-weights gene length and effective
    length, writes quant.genes.sf
"""

from __future__ import annotations

import os
import re

_MIN_TPM = 4.9406564584124654e-324  # denorm_min, reference :939


class TranscriptGeneMap:
    def __init__(self, t2g: dict[str, str]):
        self._t2g = dict(t2g)

    def gene_name(self, transcript: str) -> str:
        # reference TranscriptGeneMap falls back to the transcript's own
        # name when it is unknown to the map
        return self._t2g.get(transcript, transcript)

    @property
    def num_transcripts(self) -> int:
        return len(self._t2g)

    @property
    def num_genes(self) -> int:
        return len(set(self._t2g.values()))


_ATTR_RE = re.compile(r'(\S+)\s+"([^"]*)"')


def transcript_gene_map_from_gtf(path: str, key: str = "gene_id") -> TranscriptGeneMap:
    t2g: dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 9:
                continue
            attrs = dict(_ATTR_RE.findall(fields[8]))
            tid = attrs.get("transcript_id")
            if not tid:
                continue
            gene = attrs.get(key) or attrs.get("gene_id") or tid
            t2g.setdefault(tid, gene)
    return TranscriptGeneMap(t2g)


def read_transcript_to_gene_map(path: str) -> TranscriptGeneMap:
    t2g: dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            toks = line.split()
            if len(toks) >= 2:
                t2g[toks[0]] = toks[1]
    return TranscriptGeneMap(t2g)


def aggregate_estimates_to_gene_level(tgm: TranscriptGeneMap, quant_sf_path: str) -> str:
    """Aggregate quant.sf -> quant.genes.sf (reference :929-1040)."""
    comments: list[str] = []
    gene_rows: dict[str, list[tuple[str, float, float, list[float]]]] = {}
    header_line = True
    with open(quant_sf_path) as fh:
        for line in fh:
            stripped = line.strip()
            if not stripped:
                continue
            if stripped.startswith("#"):
                comments.append(line.rstrip("\n"))
                continue
            if header_line:
                comments.append(line.rstrip("\n"))
                header_line = False
                continue
            toks = stripped.split()
            target = toks[0]
            length = float(toks[1])
            eff_length = float(toks[2])
            exp_vals = [float(t) for t in toks[3:]]  # [TPM, NumReads, ...]
            gene = tgm.gene_name(target)
            gene_rows.setdefault(gene, []).append(
                (target, length, eff_length, exp_vals)
            )

    out_path = os.path.splitext(quant_sf_path)[0] + ".genes.sf"
    with open(out_path, "w") as out:
        for c in comments:
            out.write(c + "\n")
        for gene, rows in gene_rows.items():
            ne = len(rows[0][3])
            exp_sums = [0.0] * ne
            for _, _, _, ev in rows:
                for i in range(ne):
                    exp_sums[i] += ev[i]
            total_tpm = exp_sums[0]
            gene_len = 0.0
            gene_eff_len = 0.0
            if total_tpm > _MIN_TPM:
                for _, length, eff, ev in rows:
                    frac = ev[0] / total_tpm
                    gene_len += length * frac
                    gene_eff_len += eff * frac
            else:
                frac = 1.0 / len(rows)
                for _, length, eff, _ in rows:
                    gene_len += length * frac
                    gene_eff_len += eff * frac
            out.write(f"{gene}\t{gene_len:.6g}\t{gene_eff_len:.6g}")
            for v in exp_sums:
                out.write(f"\t{v:.6g}")
            out.write("\n")
    return out_path


def generate_gene_level_estimates(
    gene_map_path: str, est_dir: str, agg_key: str = "gene_id"
) -> str:
    """reference generateGeneLevelEstimates (src/SailfishUtils.cpp:1042-1088)."""
    ext = os.path.splitext(gene_map_path)[1].lower()
    if ext in (".gtf", ".gff"):
        tgm = transcript_gene_map_from_gtf(gene_map_path, agg_key)
    else:
        tgm = read_transcript_to_gene_map(gene_map_path)
    quant_sf = os.path.join(est_dir, "quant.sf")
    if not os.path.exists(quant_sf):
        raise FileNotFoundError(
            f"could not find isoform-level file {quant_sf}"
        )
    return aggregate_estimates_to_gene_level(tgm, quant_sf)
