"""The port's emitted server (``serve_gpu.py``) against the JAX package's
emitted ``serve_tpu.py``, each rendered from the JAX planner's service of
``samples/gpu-training/llama-serve`` and run from its payload in a
subprocess on the CPU, each from its own side's checkpoint of the same
tiny HF Llama (ported by its own ``port_weights.py``).

Both servers run their models in fp32 (the wrapper each is started
through sets the Llama config's dtype; the programs' own default is bf16)
and both with ``M2KT_ASYNC_DECODE=off``. Their greedy ``/generate``
streams are equal for 3 prompts, and so are their SSE events. An
unmeetable ``X-M2KT-Deadline`` gets 504 from both; ``/drain`` then
SIGTERM ends the port's server with exit 0. The port's server under
``M2KT_ASYNC_DECODE=on`` and ``M2KT_DECODE_SUBSTEPS`` 2 and 4 gives the
JAX server's async streams (windows of 4), SSE included. The warm request
reaches neither ``/stats`` nor ``/metrics`` nor the SLO ledger, so the
anomaly watchdog captures nothing at start. The port's router role in
front of the port's decode server, and its prefill role handing KV to
the decode server's ``/install``, give the same streams.
``M2KT_SERVE_KERNELS=off`` exits 2, and no card without
``M2KT_DEVICE=cpu`` exits non-zero. Subprocesses run in ``tmp_path`` with an env holding no
``M2KT_*`` key but the ones set here, are killed in ``finally``, and bind
their ports at 0 (the JAX server, which prints no bound port, gets one
found free).
"""

import json
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import tests.test_torch_threads  # noqa: E402,F401 - one torch thread

from move2kube_tpu.containerizer import jax_emit  # noqa: E402
from tests.test_torch_emitted_train import (  # noqa: E402
    _env,
    _hf_llama,
    _run,
    _service,
    _write,
)
from move2kube_tpu_torch.containerizer import cuda_emit  # noqa: E402

TINY = {"M2KT_VOCAB": "256", "M2KT_DMODEL": "64", "M2KT_LAYERS": "2",
        "M2KT_HEADS": "4", "M2KT_KV_HEADS": "2", "M2KT_MLP_DIM": "128",
        "M2KT_SERVE_MAX_SEQ": "128", "M2KT_SERVE_MAX_BATCH": "4",
        "M2KT_WEIGHTS_PORT": "0", "M2KT_DRAIN_GRACE_S": "5"}
PROMPTS = [[5, 17, 99, 3], [200, 1, 1, 42, 7, 7, 8, 250, 9],
           list(range(30, 50))]
NEW = 8
START_S = 120
JAX_FP32 = ("import functools, jax, jax.numpy as jnp; "
            "jax.config.update('jax_platforms', 'cpu'); "
            "from move2kube_tpu.models import llama; "
            "llama.LlamaConfig = functools.partial(llama.LlamaConfig, "
            "dtype=jnp.float32); import runpy; "
            "runpy.run_path('serve_tpu.py', run_name='__main__')")
PORT_FP32 = ("import functools, torch; "
             "from move2kube_tpu_torch.models import llama; "
             "llama.LlamaConfig = functools.partial(llama.LlamaConfig, "
             "dtype=torch.float32); import runpy; "
             "runpy.run_path('serve_gpu.py', run_name='__main__')")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url, doc=None, headers=None, data=None, timeout=60):
    if doc is not None:
        data = json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


class Child:
    """A server in a subprocess, its output in a file."""

    def __init__(self, tmp: Path, name: str, cwd: Path, code: str, env):
        self.log = tmp / f"{name}.log"
        self._out = open(self.log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], cwd=cwd, env=env,
            stdout=self._out, stderr=subprocess.STDOUT, text=True)

    def text(self) -> str:
        return self.log.read_text()

    def wait_line(self, prefix: str) -> str:
        t_end = time.monotonic() + START_S
        while time.monotonic() < t_end:
            for line in self.text().splitlines():
                if line.startswith(prefix):
                    return line
            if self.proc.poll() is not None:
                break
            time.sleep(0.2)
        raise AssertionError(f"no {prefix!r}:\n{self.text()[-3000:]}")

    def url(self, prefix: str) -> str:
        port = int(self.wait_line(prefix).split(":", 2)[-1].split()[0])
        return f"http://127.0.0.1:{port}"

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._out.close()


def _generate(base, prompt, stream=False, headers=None):
    code, body = _http(base + "/generate",
                       {"prompt": prompt, "max_new_tokens": NEW,
                        "stream": stream}, headers)
    assert code == 200, body
    if stream:
        return [json.loads(x[len(b"data: "):])
                for x in body.split(b"\n\n") if x.strip()]
    return json.loads(body)["tokens"]


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both payloads and both checkpoints of the same HF weights."""
    tmp = tmp_path_factory.mktemp("serve")
    svc, plan = _service("llama-serve")
    jdir = _write(jax_emit.emit_container(svc, plan).new_files, tmp / "jax")
    pdir = _write(cuda_emit.emit_container(svc).new_files, tmp / "port")
    (tmp / "hf").mkdir()
    _hf_llama(tmp / "hf" / "pytorch_model.bin")
    for cwd, ckpt in ((jdir, "ckpt-jax"), (pdir, "ckpt-port")):
        res = _run(cwd, [sys.executable, "port_weights.py", str(tmp / "hf"),
                         str(tmp / ckpt)], _env(tmp))
        assert res.returncode == 0, res.stderr[-3000:]
    return tmp, jdir, pdir


def _port_env(tmp, **knobs):
    return _env(tmp, M2KT_DEVICE="cpu", M2KT_SERVE_PORT=0,
                M2KT_CKPT_DIR=tmp / "ckpt-port", **TINY, **knobs)


def test_port_server_matches_the_jax_server(sides):
    tmp, jdir, pdir = sides
    jport = _free_port()
    jax_srv = Child(tmp, "jax", jdir, JAX_FP32, _env(
        tmp, M2KT_SERVE_PORT=jport, M2KT_ASYNC_DECODE="off",
        M2KT_CKPT_DIR=tmp / "ckpt-jax", **TINY))
    port_srv = Child(tmp, "port", pdir, PORT_FP32,
                     _port_env(tmp, M2KT_ASYNC_DECODE="off"))
    try:
        pbase = port_srv.url("[m2kt] serving on :")
        jax_srv.wait_line("[m2kt] serving on :")
        jbase = f"http://127.0.0.1:{jport}"
        for base in (jbase, pbase):
            assert _http(base + "/healthz")[0] == 200
        for prompt in PROMPTS:
            want = _generate(jbase, prompt)
            assert len(want) == NEW
            assert _generate(pbase, prompt) == want
        for prompt in PROMPTS[:2]:
            events = _generate(pbase, prompt, stream=True)
            assert events == _generate(jbase, prompt, stream=True)
            assert events[-1] == {"finish_reason": "length"}
        # a deadline the engines' decode latency cannot meet: shed, 504
        late = {"X-M2KT-Deadline": "0.0001"}
        for base in (jbase, pbase):
            code, body = _http(base + "/generate",
                               {"prompt": PROMPTS[2], "max_new_tokens": 64},
                               late)
            assert code == 504, body
        stats = json.loads(_http(pbase + "/stats")[1])
        # the traffic's passes; the warm request's are a record beside
        assert stats["passes"]["prefill"] == len(PROMPTS) + 2
        assert stats["warm"]["passes"]["prefill"] == 1
        # the plain versions on the CPU launch no kernel
        assert set(stats["launches"].values()) == {0}
        code, body = _http(pbase + "/drain", {})
        assert code == 200 and json.loads(body) == {"drained": True}
        assert _http(pbase + "/readyz")[0] == 503
        code, _ = _http(pbase + "/generate", {"prompt": [1],
                                              "max_new_tokens": 2})
        assert code == 503
        port_srv.proc.send_signal(signal.SIGTERM)
        assert port_srv.proc.wait(timeout=60) == 0
        assert "[m2kt] drained clean=True" in port_srv.text()
    finally:
        jax_srv.stop()
        port_srv.stop()


def test_router_and_prefill_roles_give_the_same_streams(sides):
    tmp, _, pdir = sides
    decode = Child(tmp, "decode", pdir, PORT_FP32,
                   _port_env(tmp, M2KT_FLEET_ROLE="decode"))
    children = [decode]
    try:
        dbase = decode.url("[m2kt] serving on :")
        want = [_generate(dbase, p) for p in PROMPTS]
        prefill = Child(tmp, "prefill", pdir, PORT_FP32,
                        _port_env(tmp, M2KT_FLEET_ROLE="prefill"))
        children.append(prefill)
        router = Child(tmp, "router", pdir, PORT_FP32, _env(
            tmp, M2KT_FLEET_ROLE="router", M2KT_SERVE_PORT=0,
            M2KT_ROUTER_BACKENDS=dbase[len("http://"):]))
        children.append(router)
        rbase = router.url("[m2kt] fleet router on :")
        got = []
        for prompt in PROMPTS:
            code, body = _http(rbase + "/generate",
                               {"prompt": prompt, "max_new_tokens": NEW})
            assert code == 200, body
            got.append(json.loads(body)["tokens"])
        assert got == want
        pbase = prefill.url("[m2kt] fleet prefill on :")
        for i, prompt in enumerate(PROMPTS):
            code, handoff = _http(pbase + "/prefill",
                                  {"prompt": prompt, "max_new_tokens": NEW,
                                   "rid": f"h{i}"})
            assert code == 200, handoff
            code, body = _http(dbase + "/install", data=handoff)
            assert code == 200, body
            doc = json.loads(body)
            assert doc["tokens"] == want[i]
            assert doc["rid"] == f"h{i}" and doc["prompt_len"] == len(prompt)
    finally:
        for child in children:
            child.stop()


@pytest.fixture(scope="module")
def jax_async_streams(sides):
    """The JAX server's streams under its async pipeline, windows of 4:
    ``/generate`` for every prompt, and SSE events for the first."""
    tmp, jdir, _ = sides
    jport = _free_port()
    srv = Child(tmp, "jax-async", jdir, JAX_FP32, _env(
        tmp, M2KT_SERVE_PORT=jport, M2KT_ASYNC_DECODE="on",
        M2KT_DECODE_SUBSTEPS=4, M2KT_CKPT_DIR=tmp / "ckpt-jax", **TINY))
    try:
        srv.wait_line("[m2kt] serving on :")
        base = f"http://127.0.0.1:{jport}"
        return ([_generate(base, p) for p in PROMPTS],
                _generate(base, PROMPTS[0], stream=True))
    finally:
        srv.stop()


@pytest.mark.parametrize("knobs", [
    {"M2KT_ASYNC_DECODE": "on"},
    {"M2KT_DECODE_SUBSTEPS": "2"},
    {"M2KT_ASYNC_DECODE": "on", "M2KT_DECODE_SUBSTEPS": "4"},
])
def test_async_knobs_serve_the_jax_servers_streams(sides, jax_async_streams,
                                                   knobs):
    """The port's server under the async knobs serves (they were refused
    before the pipeline was ported): its streams and SSE events equal the
    JAX server's under its own pipeline, its engine runs the pipeline at
    the asked width, and it drains to exit 0."""
    tmp, _, pdir = sides
    want, want_sse = jax_async_streams
    srv = Child(tmp, "port-async", pdir, PORT_FP32, _port_env(tmp, **knobs))
    try:
        base = srv.url("[m2kt] serving on :")
        assert [_generate(base, p) for p in PROMPTS] == want
        assert _generate(base, PROMPTS[0], stream=True) == want_sse
        stats = json.loads(_http(base + "/stats")[1])
        assert stats["async_decode"] is True
        assert stats["decode_substeps"] == int(
            knobs.get("M2KT_DECODE_SUBSTEPS", 1))
        assert _http(base + "/drain", {})[0] == 200
        srv.proc.send_signal(signal.SIGTERM)
        assert srv.proc.wait(timeout=60) == 0
    finally:
        srv.stop()


def test_warm_request_reaches_no_record(sides):
    """With a TTFT objective every request breaks, the warm request would
    fire the SLO fast burn and a diagnostic capture: after warming,
    ``/stats`` counts no request, ``/metrics`` no TTFT, the SLO ledger
    nothing (no fast burn) and no ``diag-*`` bundle exists past a
    watchdog check. One real request then does fire the capture."""
    tmp, _, pdir = sides
    diag = tmp / "diag-warm"
    srv = Child(tmp, "port-warm", pdir, PORT_FP32, _port_env(
        tmp, M2KT_METRICS_PORT=_free_port(), M2KT_SLO_TTFT_P95_S="1e-9",
        M2KT_DIAG_DIR=diag, M2KT_DIAG_PROFILE_S="0.1"))
    try:
        base = srv.url("[m2kt] serving on :")
        metrics = srv.url("[m2kt] telemetry on :") + "/metrics"
        stats = json.loads(_http(base + "/stats")[1])
        assert stats["warm"]["passes"]["prefill"] == 1
        assert stats["decode_steps"] == stats["prefills"] == 0
        assert set(stats["passes"].values()) == {0}
        assert stats["ttft_p50_ms"] == 0.0
        time.sleep(6.0)  # past the watchdog's first check (every 5 s)
        text = _http(metrics)[1].decode()
        assert "m2kt_serve_ttft_seconds_count 0" in text
        assert "m2kt_slo_fast_burn_firing 0" in text
        assert not diag.exists() or not list(diag.glob("diag-*"))
        _generate(base, PROMPTS[0])
        t_end = time.monotonic() + 30
        while time.monotonic() < t_end and not (
                diag.exists() and list(diag.glob("diag-slo_fast_burn-*"))):
            time.sleep(0.5)
        assert list(diag.glob("diag-slo_fast_burn-*"))
    finally:
        srv.stop()


@pytest.mark.parametrize("knob,value,says", [
    ("M2KT_SERVE_KERNELS", "off", "no plain attention path on a card"),
])
def test_knobs_the_port_lacks_exit_2(sides, knob, value, says):
    tmp, _, pdir = sides
    res = _run(pdir, [sys.executable, "serve_gpu.py"],
               _port_env(tmp, **{knob: value}), timeout=120)
    assert res.returncode == 2, res.stderr[-2000:]
    assert says in res.stdout
    assert "serving on" not in res.stdout


def test_no_card_and_no_cpu_knob_exits_nonzero(sides):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    tmp, _, pdir = sides
    env = _port_env(tmp)
    env.pop("M2KT_DEVICE")
    res = _run(pdir, [sys.executable, "serve_gpu.py"], env, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "serving on" not in res.stdout
