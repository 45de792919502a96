"""Numerics-diff validation harness of the port: the counterpart of the
JAX package's ``source/validate.py``.

A translated trainer is only believable if its numbers match the
source's declared semantics. This module runs two sides on identical
synthetic batches and gates on their deltas:

- the **translated side** is the emitted trainer's machinery: the tiny
  model under the precision policy (bf16 compute over fp32 master
  weights by default; ``M2KT_PRECISION`` overrides), the port's
  ``make_lm_train_step`` and ``instrument_optimizer``'s recorders;
- the **reference side** replays the declared semantics: fp32 math,
  the same architecture, and the optimizer and learning rate the source
  declares. Both sides start from the translated side's fp32 master
  weights, so every delta is execution semantics, not init luck.

The declared semantics arrive as a dict (``{"family", "optimizer",
"lr", "entrypoint", "evidence"}``): reading them from a source tree is
the translator's source analysis, which the port does not carry.

Gates: initial-logit max-rel error (``serving/quant.logit_gate``'s
row-span normalization), first-step gradient-norm delta, per-step
loss-trajectory delta, and finiteness of both trajectories. ``perturb``
corrupts the translated side's applied updates (a dict of name ->
update tensor in, the same out): how a test proves a broken translation
fails. Results land in ``m2kt-numerics-report.{json,md}``, with the
reference's keys.
"""

from __future__ import annotations

import json
import os

DEFAULT_STEPS = 4
# gate envs: M2KT_NUMERICS_<NAME>; the defaults absorb bf16-vs-fp32
# rounding on the tiny configs while failing hard on a wrong optimizer
# mapping, a double-applied loss scale, or corrupted updates
DEFAULT_GATES = {
    "logit_max_rel": 0.05,      # initial logits, row-span normalized
    "grad_norm_max_rel": 0.15,  # first-step global grad norm delta
    "loss_max_rel": 0.10,       # per-step loss trajectory delta
}

DEFAULT_SEMANTICS = {"family": "llama", "optimizer": "adamw", "lr": 5e-5,
                     "entrypoint": "", "evidence": []}


def gates_from_env(overrides: dict | None = None) -> dict:
    out = dict(DEFAULT_GATES)
    for key in out:
        raw = os.environ.get(f"M2KT_NUMERICS_{key.upper()}", "")
        if raw:
            try:
                out[key] = float(raw)
            except ValueError:
                pass
    out.update(overrides or {})
    return out


def _build_optimizer(name: str, lr: float, params):
    import torch

    from move2kube_tpu_torch.models import train as m2kt_train

    if name == "sgd":
        # torch.optim.SGD's default momentum is 0; the samples pass 0.9,
        # and the same optimizer drives both sides, so the choice cancels
        return m2kt_train.Optimizer(torch.optim.SGD(params, lr=lr,
                                                    momentum=0.9))
    if name == "adam":
        return m2kt_train.adam(params, lr)
    return m2kt_train.adamw(params, lr)


def _tiny_model(family: str):
    """(init(dtype, device, seed), vocab, proxy) for a source family. LM
    families get their own tiny config; everything else runs the Llama
    proxy (the precision, step and optimizer semantics under test do
    not depend on the family, and the report says so)."""
    from move2kube_tpu_torch.models import convert

    if family in ("gpt2", "gpt"):
        from move2kube_tpu_torch.models.gpt2 import gpt2_tiny

        cfg = gpt2_tiny()
        return (lambda dtype, dev, seed: convert.init_gpt2(
            cfg, seed=seed, device=dev, dtype=dtype), cfg.vocab_size, False)
    from move2kube_tpu_torch.models.llama import llama_tiny

    cfg = llama_tiny()
    return (lambda dtype, dev, seed: convert.init_llama(
        cfg, seed=seed, device=dev, dtype=dtype), cfg.vocab_size,
        family not in ("llama",))


def _perturbing(opt, model, perturb) -> None:
    """Chain ``perturb`` onto ``opt``'s applied updates: each step's update
    (new minus old parameters) goes through it and is applied instead."""
    import torch

    inner_step = opt.inner.step
    names = {id(p): n for n, p in model.named_parameters()}

    def step(*args, **kwargs):
        params = opt.params()
        before = [p.detach().clone() for p in params]
        out = inner_step(*args, **kwargs)
        updates = perturb({names[id(p)]: p.detach() - b
                           for p, b in zip(params, before)})
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b + updates[names[id(p)]])
        return out

    opt.inner.step = step


def validate_translation(semantics: dict | None = None,
                         family: str | None = None,
                         steps: int = DEFAULT_STEPS,
                         batch: int = 2, seq: int = 16, seed: int = 0,
                         gates: dict | None = None,
                         perturb=None,
                         out_dir: str | None = None,
                         device=None) -> dict:
    """Run the numerics diff and return the report dict (``verdict``:
    ``"pass"``/``"fail"``, per-check entries, both loss trajectories).
    ``semantics`` is the declared source semantics (defaults: AdamW at
    5e-5, Llama); ``family`` overrides its family; ``perturb`` corrupts
    the translated side's updates; ``out_dir`` also writes
    ``m2kt-numerics-report.{json,md}``. Runs on the card unless
    ``device="cpu"``."""
    import numpy as np
    import torch

    from move2kube_tpu_torch._device import resolve_device
    from move2kube_tpu_torch.models import precision as precisionlib
    from move2kube_tpu_torch.models import train as m2kt_train
    from move2kube_tpu_torch.serving.quant import logit_gate

    dev = resolve_device(device)
    sem = dict(DEFAULT_SEMANTICS)
    sem.update(semantics or {})
    fam = family or sem["family"]
    gate = gates_from_env(gates)
    init, vocab, proxy = _tiny_model(fam)

    gen = np.random.default_rng(seed)
    batches = [torch.from_numpy(gen.integers(0, vocab, (batch, seq)))
               .to(dev) for _ in range(steps)]
    ids0 = batches[0]

    # translated side: the emitted trainer's machinery, tiny-sized
    policy = precisionlib.from_env(default="bf16")
    model_t = init(torch.float32, dev, seed)
    opt_t = m2kt_train.instrument_optimizer(policy.wrap_optimizer(
        _build_optimizer(sem["optimizer"], sem["lr"],
                         model_t.parameters())))
    if perturb is not None:
        _perturbing(opt_t, model_t, perturb)
    state = m2kt_train.TrainState(model_t, opt_t)
    step_t = m2kt_train.make_lm_train_step(remat=False, precision=policy)

    # reference side: the declared semantics, fp32 throughout, from the
    # translated side's initial master weights
    model_r = init(torch.float32, dev, seed)
    model_r.load_state_dict(model_t.state_dict())
    opt_r = _build_optimizer(sem["optimizer"], sem["lr"],
                             model_r.parameters())

    def step_r(ids):
        opt_r.zero_grad()
        loss = m2kt_train.lm_loss(model_r(ids), ids)
        loss.backward()
        gnorm = m2kt_train.global_norm(
            [p.grad for p in model_r.parameters() if p.grad is not None])
        opt_r.step()
        return float(loss.detach()), float(gnorm)

    # initial logits: same weights, the compute-dtype view vs fp32
    with torch.no_grad():
        logits_t = torch.func.functional_call(
            model_t, policy.cast_params(dict(model_t.named_parameters())),
            (ids0,))
        logits_r = model_r(ids0)
    logit_stats = logit_gate(logits_r.float().cpu().numpy(),
                             logits_t.float().cpu().numpy())

    loss_t, loss_r, gnorm_t, gnorm_r = [], [], None, None
    for i, ids in enumerate(batches):
        state, lt = step_t(state, {"input_ids": ids})
        loss_t.append(float(lt))
        if i == 0:
            gnorm_t = m2kt_train.grad_norm_from_state(state)
        lr_, gn = step_r(ids)
        loss_r.append(lr_)
        if i == 0:
            gnorm_r = gn

    eps = 1e-9
    grad_rel = (abs(gnorm_t - gnorm_r) / max(abs(gnorm_r), eps)
                if gnorm_t is not None else 0.0)
    loss_rel = max(abs(a - b) / max(abs(b), eps)
                   for a, b in zip(loss_t, loss_r))
    finite = bool(all(np.isfinite(loss_t)) and all(np.isfinite(loss_r)))
    checks = [
        {"name": "logit_max_rel", "value": logit_stats["max_rel_err"],
         "limit": gate["logit_max_rel"],
         "ok": logit_stats["max_rel_err"] <= gate["logit_max_rel"]},
        {"name": "grad_norm_max_rel", "value": grad_rel,
         "limit": gate["grad_norm_max_rel"],
         "ok": grad_rel <= gate["grad_norm_max_rel"]},
        {"name": "loss_max_rel", "value": loss_rel,
         "limit": gate["loss_max_rel"],
         "ok": loss_rel <= gate["loss_max_rel"]},
        {"name": "trajectories_finite", "value": float(finite),
         "limit": 1.0, "ok": finite},
    ]
    report = {
        "verdict": "pass" if all(c["ok"] for c in checks) else "fail",
        "family": fam,
        "proxy_model": proxy,
        "precision_policy": policy.name,
        "source": {"dir": sem.get("dir", ""),
                   "entrypoint": sem["entrypoint"],
                   "optimizer": sem["optimizer"], "lr": sem["lr"],
                   "evidence": sem["evidence"]},
        "steps": steps,
        "checks": checks,
        "logit_gate": logit_stats,
        "loss_translated": loss_t,
        "loss_reference": loss_r,
        "grad_norm": {"translated": gnorm_t, "reference": gnorm_r},
    }
    if out_dir:
        write_report(report, out_dir)
    return report


def write_report(report: dict, out_dir: str) -> tuple[str, str]:
    """``m2kt-numerics-report.json`` (machine) + ``.md`` (review)."""
    os.makedirs(out_dir, exist_ok=True)
    jpath = os.path.join(out_dir, "m2kt-numerics-report.json")
    with open(jpath, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    lines = [
        "# Numerics validation report",
        "",
        f"**Verdict: {report['verdict'].upper()}**",
        "",
        f"- family: `{report['family']}`"
        + (" (proxy model)" if report.get("proxy_model") else ""),
        f"- precision policy: `{report['precision_policy']}`",
        f"- source optimizer: `{report['source']['optimizer']}` @ "
        f"lr={report['source']['lr']}",
        f"- steps compared: {report['steps']}",
        "",
        "| check | value | limit | ok |",
        "|---|---|---|---|",
    ]
    for c in report["checks"]:
        lines.append(f"| {c['name']} | {c['value']:.6g} | "
                     f"{c['limit']:.6g} | {'yes' if c['ok'] else 'NO'} |")
    lines += [
        "",
        f"- loss (translated): "
        f"{[round(x, 4) for x in report['loss_translated']]}",
        f"- loss (reference):  "
        f"{[round(x, 4) for x in report['loss_reference']]}",
        "",
    ]
    mpath = os.path.join(out_dir, "m2kt-numerics-report.md")
    with open(mpath, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines))
    return jpath, mpath


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="diff the port's training machinery against declared "
                    "source semantics on identical synthetic batches")
    parser.add_argument("--semantics", default="",
                        help="JSON file of the declared semantics "
                             "(family, optimizer, lr); AdamW at 5e-5 on "
                             "Llama when absent")
    parser.add_argument("--out", default=".",
                        help="where m2kt-numerics-report.{json,md} land")
    parser.add_argument("--steps", type=int, default=DEFAULT_STEPS)
    parser.add_argument("--device", default=None,
                        help="cpu to run off the card")
    args = parser.parse_args(argv)
    sem = None
    if args.semantics:
        with open(args.semantics, encoding="utf-8") as fh:
            sem = json.load(fh)
    report = validate_translation(semantics=sem, steps=args.steps,
                                  out_dir=args.out, device=args.device)
    print(f"[m2kt-numerics] {report['verdict']}: " + ", ".join(
        f"{c['name']}={c['value']:.4g}/{c['limit']:.4g}"
        for c in report["checks"]))
    return 0 if report["verdict"] == "pass" else 1


if __name__ == "__main__":
    raise SystemExit(main())
