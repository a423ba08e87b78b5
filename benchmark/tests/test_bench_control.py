"""The controls and the planted faults come out not correct (CPU, toy
size): the port's own compacted scan (`--scanShrink 2`) and the float32
reference in the program's place are the controls; each fault breaks the
timed path underneath a run."""

import numpy as np
import pytest
from conftest import toy_run

from sailfish_tpu_torch.infer import em as port_em
from sailfish_tpu_torch.map import pipeline


@pytest.mark.parametrize("cell", ["toy_ecoli.map", "toy_gencode.map",
                                  "toy_gencode.em"])
def test_control_is_not_correct(toy_root, cell):
    _, out = toy_run(toy_root, cell, control=True)
    assert not out["correct"], out["checks"]


def _fold_half(self, token, acc):
    """A fold that leaves out half of the batch's classes, known and
    new alike."""
    def half(counts):
        return np.where(np.arange(len(counts)) % 2 == 0, counts, 0)

    known, new = acc.add_hashed, acc.register_new
    acc.add_hashed = lambda keys, counts: known(keys, half(counts))
    acc.register_new = lambda keys, labels, counts: new(keys, labels,
                                                        half(counts))
    try:
        return ORIG_FOLD(self, token, acc)
    finally:
        del acc.add_hashed, acc.register_new


def _labels_altered(res, rep_idx, rep_lens):
    """Labels altered where they are produced: the last transcript of
    each new class moved to its neighbour."""
    out = ORIG_LABELS(res, rep_idx, rep_lens)
    return [lab[:-1] + (lab[-1] + 1,) for lab in out]


ORIG_FOLD = pipeline.DeviceMapperBackend.finish_batch_fast
ORIG_LABELS = pipeline.DeviceMapperBackend._fetch_labels


@pytest.mark.parametrize("cell", ["toy_ecoli.map", "toy_gencode.map"])
@pytest.mark.parametrize("fault", ["half_fold", "labels"])
def test_map_fault_is_not_correct(toy_root, monkeypatch, cell, fault):
    if fault == "half_fold":
        monkeypatch.setattr(pipeline.DeviceMapperBackend,
                            "finish_batch_fast", _fold_half)
    else:
        monkeypatch.setattr(pipeline.DeviceMapperBackend, "_fetch_labels",
                            staticmethod(_labels_altered))
    _, out = toy_run(toy_root, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_em_fault_is_not_correct(toy_root, monkeypatch, fault):
    orig = port_em._em_step
    if fault == "unchanged":
        step = lambda p, alpha: alpha  # noqa: E731
    elif fault == "half":
        def step(p, alpha):
            # half of the classes left out, their mass spread on the rest
            out = orig(p, alpha)
            keep = out.clone()
            keep[1::2] = 0
            return keep * out.sum() / keep.sum()
    else:
        def step(p, alpha):
            out = orig(p, alpha)
            out[0] += 1.0
            return out
    monkeypatch.setattr(port_em, "_em_step", step)
    _, out = toy_run(toy_root, "toy_gencode.em")
    assert not out["correct"], out["checks"]
