"""The port's HuggingFace and torchvision converters and its emitted
``port_weights.py``.

Each converter (``move2kube_tpu_torch/models/convert.py``) takes a tiny
state dict in the upstream layout, written with torch (Llama with GQA,
GPT-2's ``Conv1D``, BERT for sequence classification, a torchvision
ResNet-50 layout at a narrow width), and must give, bit for bit, what
the JAX package's converter gives passed through ``params_from_jax``;
the result loads into the port's model with ``strict=True``.
``infer_num_layers`` agrees with the reference's. The emitted
``port_weights.py`` runs in a subprocess and writes the trainer's step-0
checkpoint; for ``unet`` it refuses.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.models import convert as jconvert  # noqa: E402
from move2kube_tpu_torch.containerizer import cuda_emit  # noqa: E402
from move2kube_tpu_torch.models import convert as tconvert  # noqa: E402
from move2kube_tpu_torch.models.bert import BertConfig, BertEncoder  # noqa: E402
from move2kube_tpu_torch.models.checkpoint import restore_variables  # noqa: E402
from move2kube_tpu_torch.models.gpt2 import GPT2, GPT2Config  # noqa: E402
from move2kube_tpu_torch.models.llama import Llama, LlamaConfig  # noqa: E402
from move2kube_tpu_torch.models.resnet import ResNet, ResNetConfig  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
F32 = torch.float32


def _draw(gen, *shape, scale=0.05):
    return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)
                            * np.float32(scale))


def _norm(gen, sd, prefix, c, bias=True):
    sd[prefix + ".weight"] = torch.from_numpy(
        gen.random(c).astype(np.float32) + 0.5)
    if bias:
        sd[prefix + ".bias"] = _draw(gen, c, scale=0.01)


def hf_llama(layers=2, v=64, d=32, heads=4, kv=2, mlp=48, prefix="model.",
             tied=False, seed=0):
    gen = np.random.default_rng(seed)
    hd = d // heads
    sd = {prefix + "embed_tokens.weight": _draw(gen, v, d)}
    _norm(gen, sd, prefix + "norm", d, bias=False)
    for i in range(layers):
        lp = f"{prefix}layers.{i}."
        for name, shape in (("self_attn.q_proj", (heads * hd, d)),
                            ("self_attn.k_proj", (kv * hd, d)),
                            ("self_attn.v_proj", (kv * hd, d)),
                            ("self_attn.o_proj", (d, heads * hd)),
                            ("mlp.gate_proj", (mlp, d)),
                            ("mlp.up_proj", (mlp, d)),
                            ("mlp.down_proj", (d, mlp))):
            sd[lp + name + ".weight"] = _draw(gen, *shape)
        _norm(gen, sd, lp + "input_layernorm", d, bias=False)
        _norm(gen, sd, lp + "post_attention_layernorm", d, bias=False)
    if not tied:
        sd["lm_head.weight"] = _draw(gen, v, d)
    cfg = LlamaConfig(vocab_size=v, d_model=d, num_layers=layers,
                      num_heads=heads, num_kv_heads=kv, mlp_dim=mlp,
                      max_len=64, dtype=F32)
    return sd, cfg


def hf_gpt2(layers=2, v=64, d=32, heads=4, pos=32, prefix="transformer.",
            seed=1):
    gen = np.random.default_rng(seed)
    sd = {prefix + "wte.weight": _draw(gen, v, d),
          prefix + "wpe.weight": _draw(gen, pos, d)}
    _norm(gen, sd, prefix + "ln_f", d)
    for i in range(layers):
        lp = f"{prefix}h.{i}."
        # HF Conv1D: weight [in, out]
        for name, (i_, o) in (("attn.c_attn", (d, 3 * d)),
                              ("attn.c_proj", (d, d)),
                              ("mlp.c_fc", (d, 4 * d)),
                              ("mlp.c_proj", (4 * d, d))):
            sd[lp + name + ".weight"] = _draw(gen, i_, o)
            sd[lp + name + ".bias"] = _draw(gen, o, scale=0.01)
        _norm(gen, sd, lp + "ln_1", d)
        _norm(gen, sd, lp + "ln_2", d)
    cfg = GPT2Config(vocab_size=v, n_positions=pos, d_model=d,
                     num_layers=layers, num_heads=heads, dtype=F32)
    return sd, cfg


def hf_bert(layers=2, v=64, d=16, heads=2, mlp=32, pos=24, classes=3,
            prefix="bert.", seed=2):
    gen = np.random.default_rng(seed)
    emb = prefix + "embeddings."
    sd = {emb + "word_embeddings.weight": _draw(gen, v, d),
          emb + "position_embeddings.weight": _draw(gen, pos, d),
          emb + "token_type_embeddings.weight": _draw(gen, 2, d)}
    _norm(gen, sd, emb + "LayerNorm", d)

    def linear(name, i, o):
        sd[name + ".weight"] = _draw(gen, o, i)
        sd[name + ".bias"] = _draw(gen, o, scale=0.01)

    for i in range(layers):
        lp = f"{prefix}encoder.layer.{i}."
        for x in ("query", "key", "value"):
            linear(lp + "attention.self." + x, d, d)
        linear(lp + "attention.output.dense", d, d)
        _norm(gen, sd, lp + "attention.output.LayerNorm", d)
        linear(lp + "intermediate.dense", d, mlp)
        linear(lp + "output.dense", mlp, d)
        _norm(gen, sd, lp + "output.LayerNorm", d)
    linear(prefix + "pooler.dense", d, d)
    linear("classifier", d, classes)
    cfg = BertConfig(vocab_size=v, num_layers=layers, num_heads=heads,
                     d_model=d, mlp_dim=mlp, max_len=pos,
                     num_classes=classes, dtype=F32)
    return sd, cfg


def tv_resnet50(width=4, classes=5, seed=3):
    """torchvision resnet50's names and layout at base width ``width``."""
    gen = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = _draw(gen, o, i, k, k)

    def bn(name, c):
        _norm(gen, sd, name, c)
        sd[name + ".running_mean"] = _draw(gen, c, scale=0.1)
        sd[name + ".running_var"] = torch.from_numpy(
            gen.random(c).astype(np.float32) + 0.5)
        sd[name + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    conv("conv1", width, 3, 7)
    bn("bn1", width)
    in_ch = width
    for stage, units in enumerate((3, 4, 6, 3), start=1):
        w = width * 2 ** (stage - 1)
        for unit in range(units):
            tp = f"layer{stage}.{unit}"
            conv(tp + ".conv1", w, in_ch, 1)
            bn(tp + ".bn1", w)
            conv(tp + ".conv2", w, w, 3)
            bn(tp + ".bn2", w)
            conv(tp + ".conv3", w * 4, w, 1)
            bn(tp + ".bn3", w * 4)
            if unit == 0:
                conv(tp + ".downsample.0", w * 4, in_ch, 1)
                bn(tp + ".downsample.1", w * 4)
            in_ch = w * 4
    sd["fc.weight"] = _draw(gen, classes, in_ch)
    sd["fc.bias"] = _draw(gen, classes, scale=0.01)
    cfg = ResNetConfig(stage_sizes=(3, 4, 6, 3), num_classes=classes,
                       width=width, dtype=F32)
    return sd, cfg


def _assert_bit_equal(ours: dict, ref: dict) -> None:
    assert set(ours) == set(ref)
    for name, t in ref.items():
        assert ours[name].dtype == t.dtype == F32, name
        assert ours[name].shape == t.shape, name
        assert torch.equal(ours[name], t), name


@pytest.mark.parametrize("prefix,tied", [("model.", False), ("", False),
                                         ("model.", True)])
def test_llama_converter_equals_the_reference(prefix, tied):
    sd, cfg = hf_llama(prefix=prefix, tied=tied)
    n = tconvert.infer_num_layers(sd, "llama")
    assert n == jconvert.infer_num_layers(sd, "llama") == 2
    ours = tconvert.llama_params_from_torch(sd, n)
    ref = tconvert.params_from_jax(jconvert.llama_params_from_torch(sd, n),
                                   cfg)
    _assert_bit_equal(ours, ref)
    # GQA: k and v take kvh * d rows of the fused projection
    hd = cfg.d_model // cfg.num_heads
    assert ours["layers.0.qkv.weight"].shape == (
        (cfg.num_heads + 2 * cfg.num_kv_heads) * hd, cfg.d_model)
    Llama(cfg, device="cpu").load_state_dict(ours, strict=True)


@pytest.mark.parametrize("prefix", ["transformer.", ""])
def test_gpt2_converter_equals_the_reference(prefix):
    sd, cfg = hf_gpt2(prefix=prefix)
    n = tconvert.infer_num_layers(sd, "gpt2")
    assert n == jconvert.infer_num_layers(sd, "gpt2") == 2
    ours = tconvert.gpt2_params_from_torch(sd, n)
    ref = tconvert.params_from_jax(jconvert.gpt2_params_from_torch(sd, n),
                                   cfg)
    _assert_bit_equal(ours, ref)
    # Conv1D [in, out] -> nn.Linear [out, in]
    assert torch.equal(ours["h.0.c_fc.weight"],
                       sd[prefix + "h.0.mlp.c_fc.weight"].t())
    GPT2(cfg, device="cpu").load_state_dict(ours, strict=True)


def test_bert_converter_equals_the_reference():
    sd, cfg = hf_bert()
    n = tconvert.infer_num_layers(sd, "bert")
    assert n == jconvert.infer_num_layers(sd, "bert") == 2
    ours = tconvert.bert_params_from_torch(sd, n)
    ref = tconvert.params_from_jax(jconvert.bert_params_from_torch(sd, n),
                                   cfg)
    _assert_bit_equal(ours, ref)
    BertEncoder(cfg, device="cpu").load_state_dict(ours, strict=True)


def test_resnet_converter_equals_the_reference():
    sd, cfg = tv_resnet50()
    params, stats = tconvert.resnet_params_from_torch(sd)
    jp, js = jconvert.resnet_params_from_torch(sd)
    ref = tconvert.params_from_jax({"params": jp, "batch_stats": js}, cfg)
    assert not set(params) & set(stats)
    assert all(k.endswith((".mean", ".var")) for k in stats)
    _assert_bit_equal({**params, **stats}, ref)
    ResNet(cfg, device="cpu").load_state_dict({**params, **stats},
                                              strict=True)


@pytest.mark.parametrize("family,keys", [
    ("llama", ["layers.0.x", "model.layers.3.y"]),
    ("gpt", ["model.layers.1.y"]),
    ("gpt2", ["transformer.h.5.attn.c_attn.weight", "h.0.ln_1.weight"]),
    ("bert", ["bert.encoder.layer.11.output.dense.weight"]),
])
def test_infer_num_layers_agrees(family, keys):
    sd = dict.fromkeys(keys)
    assert tconvert.infer_num_layers(sd, family) == \
        jconvert.infer_num_layers(sd, family)


@pytest.mark.parametrize("family,sd", [("gpt", {"h.0.x": 1}),
                                       ("resnet", {"layers.0.x": 1})])
def test_infer_num_layers_refuses_as_the_reference(family, sd):
    for conv in (tconvert, jconvert):
        with pytest.raises(ValueError):
            conv.infer_num_layers(sd, family)


def _port_weights(tmp_path, family: str):
    script = tmp_path / "port_weights.py"
    script.write_text(cuda_emit.render(
        (REPO / "move2kube_tpu_torch/assets/cuda/port_weights.py")
        .read_text(), {"FAMILY": family}))
    return script


def _run(tmp_path, script, *args):
    env = {k: v for k, v in os.environ.items() if not k.startswith("M2KT_")}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, str(script), *map(str, args)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)


def test_emitted_port_weights_writes_the_step0_checkpoint(tmp_path):
    sd, cfg = hf_llama()
    src = tmp_path / "hf"
    src.mkdir()
    # a full checkpoint dict with a "state_dict" key, found in a directory
    torch.save({"state_dict": sd, "epoch": 3}, src / "pytorch_model.bin")
    res = _run(tmp_path, _port_weights(tmp_path, "llama"), src,
               tmp_path / "ckpt")
    assert res.returncode == 0, res.stderr[-2000:]
    assert (f"[m2kt] ported 15 arrays -> {tmp_path / 'ckpt'} (step 0); "
            f"run training with M2KT_CKPT_DIR={tmp_path / 'ckpt'}"
            in res.stdout)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["0"]
    model = Llama(cfg, device="cpu")
    got = restore_variables(str(tmp_path / "ckpt"), model.state_dict())
    _assert_bit_equal(got, tconvert.llama_params_from_torch(sd, 2))
    assert sorted(os.listdir(tmp_path)) == ["ckpt", "hf", "port_weights.py"]


def test_emitted_port_weights_ports_resnet_stats(tmp_path):
    sd, cfg = tv_resnet50()
    torch.save(sd, tmp_path / "model.pt")
    res = _run(tmp_path, _port_weights(tmp_path, "resnet"),
               tmp_path / "model.pt", tmp_path / "ckpt")
    assert res.returncode == 0, res.stderr[-2000:]
    n = len(ResNet(cfg, device="cpu").state_dict())
    assert f"[m2kt] ported {n} arrays" in res.stdout
    params, stats = tconvert.resnet_params_from_torch(sd)
    got = restore_variables(str(tmp_path / "ckpt"),
                            ResNet(cfg, device="cpu").state_dict())
    _assert_bit_equal(got, {**params, **stats})


def test_emitted_port_weights_refuses_unet(tmp_path):
    torch.save({"x": torch.zeros(1)}, tmp_path / "model.pt")
    res = _run(tmp_path, _port_weights(tmp_path, "unet"),
               tmp_path / "model.pt", tmp_path / "ckpt")
    assert res.returncode != 0
    assert "not supported for diffusion UNets" in res.stderr
    assert "move2kube_tpu_torch/models/unet.py" in res.stderr
    assert not (tmp_path / "ckpt").exists()


def test_llama_converter_loads_into_an_fp32_master_model():
    """What the trainer's restore takes: the converted tree in the fp32
    masters of a bf16-policy Llama."""
    sd, cfg = hf_llama()
    model = Llama(dataclasses.replace(cfg, dtype=F32), device="cpu")
    model.load_state_dict(tconvert.llama_params_from_torch(sd, 2))
    assert all(p.dtype == F32 for p in model.parameters())
