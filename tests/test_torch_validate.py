"""The port's numerics-diff harness (``move2kube_tpu_torch/validate.py``)
against the JAX package's (``source/validate.py``).

Tiny Llama and GPT-2 pass the default gates, and a translation whose
updates are corrupted fails ``loss_max_rel``, as
``tests/test_numerics.py::test_validation_harness_pass_and_fail`` shows
for the JAX harness. The declared semantics come from the JAX package's
``declared_semantics`` on the samples; the reports carry the reference's
keys, and ``m2kt-numerics-report.{json,md}`` land where asked.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.source import validate as jvalidate  # noqa: E402
from move2kube_tpu_torch import validate as tvalidate  # noqa: E402

SAMPLES = Path(__file__).resolve().parent.parent / "samples" / "gpu-training"


def _keys(report: dict) -> dict:
    return {"top": sorted(report), "source": sorted(report["source"]),
            "checks": [sorted(c) for c in report["checks"]],
            "names": [c["name"] for c in report["checks"]],
            "logit_gate": sorted(report["logit_gate"])}


@pytest.mark.parametrize("sample,family", [("llama3-8b", "llama"),
                                           ("gpt2", "gpt2")])
def test_harness_passes_on_the_samples_semantics(tmp_path, sample, family):
    sem = jvalidate.declared_semantics(str(SAMPLES / sample))
    report = tvalidate.validate_translation(
        semantics=sem, family=family, steps=3, out_dir=str(tmp_path),
        device="cpu")
    assert report["verdict"] == "pass", report["checks"]
    assert report["source"]["optimizer"] == sem["optimizer"]
    assert report["source"]["lr"] == sem["lr"]
    assert report["precision_policy"] == "bf16"
    on_disk = json.loads((tmp_path / "m2kt-numerics-report.json")
                         .read_text())
    assert on_disk["verdict"] == "pass"
    md = (tmp_path / "m2kt-numerics-report.md").read_text()
    assert "PASS" in md and "loss_max_rel" in md
    ref = jvalidate.validate_translation(family=family, steps=3)
    assert _keys(report) == _keys(ref)


def test_corrupted_updates_fail_the_gate():
    broken = tvalidate.validate_translation(
        family="llama", steps=3, device="cpu",
        perturb=lambda u: {k: torch.full_like(v, 100.0)
                           for k, v in u.items()})
    assert broken["verdict"] == "fail"
    failed = {c["name"] for c in broken["checks"] if not c["ok"]}
    assert "loss_max_rel" in failed


def test_gates_and_cli(tmp_path, monkeypatch):
    assert tvalidate.DEFAULT_GATES == jvalidate.DEFAULT_GATES
    monkeypatch.setenv("M2KT_NUMERICS_LOSS_MAX_REL", "0.5")
    assert tvalidate.gates_from_env() == jvalidate.gates_from_env()
    sem = tmp_path / "sem.json"
    sem.write_text(json.dumps(jvalidate.declared_semantics(
        str(SAMPLES / "bert"))))
    rc = tvalidate.main(["--semantics", str(sem), "--steps", "2",
                         "--out", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    report = json.loads((tmp_path / "m2kt-numerics-report.json").read_text())
    assert report["family"] == "bert" and report["proxy_model"] is True
