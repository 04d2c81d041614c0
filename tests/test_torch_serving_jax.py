"""The port's generation service held against the JAX package's, on the
CPU at test_config(): the same weights (init_params(key(0)) through the
params bridge), the same payloads over real sockets, the same response
bytes (tolerance: none), on the solo, batch, primed, coalesced and
time-sliced paths."""

import base64
import json
import os

import jax
import numpy as np
import pytest

from music_generator_tpu.config import test_config as jax_test_config
from music_generator_tpu.models.deepj import init_params
from music_generator_tpu.serving.server import \
    GenerationService as JaxService
from music_generator_tpu.serving.server import _Pending as JaxPending
from music_generator_tpu.serving.server import \
    make_handler as jax_make_handler
from music_generator_tpu_torch.config import test_config as torch_test_config
from music_generator_tpu_torch.params import params_from_numpy
from music_generator_tpu_torch.serving import GenerationService
from music_generator_tpu_torch.serving.server import _Pending

from torch_serving_common import post, serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "artifacts", "short_samples_r4",
                       "short_s0_0.mid"), "rb") as _f:
    PRIME = base64.b64encode(_f.read()).decode()
MIXTURE = [float(v) for v in
           np.random.default_rng(0).dirichlet(np.ones(23)).astype(np.float32)]

# (path, payload): each posted to both services.
PAYLOADS = {
    "genre": ("/generate", {"genre": 1, "bars": 2, "seed": 3}),
    "styles": ("/generate", {"styles": [0, 4], "bars": 1, "seed": 4}),
    "mixture": ("/generate", {"mixture": MIXTURE, "bars": 1, "seed": 5}),
    "temperature_1.0": ("/generate", {"genre": 2, "bars": 1, "seed": 7,
                                      "temperature": 1.0}),
    "temperature_0.7": ("/generate", {"genre": 2, "bars": 1, "seed": 7,
                                      "temperature": 0.7}),
    "batch_of_3": ("/generate_batch", {"styles_list": [[0], [1, 2], [3]],
                                       "bars": 1, "seed": 6}),
    "primed": ("/generate", {"genre": 0, "bars": 1, "seed": 8,
                             "prime_midi": PRIME, "prime_bars": 1}),
    "primed_continuation_only": ("/generate", {
        "genre": 0, "bars": 1, "seed": 8, "prime_midi": PRIME,
        "prime_bars": 1, "continuation_only": True}),
}


@pytest.fixture(scope="module")
def services():
    """(JAX service, port service) on the same weights, not warmed up."""
    cfg = jax_test_config()
    params = init_params(jax.random.key(0), cfg)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    return (JaxService(config=cfg, params=params, warmup=False),
            GenerationService(config=torch_test_config(),
                              params=params_from_numpy(flat), warmup=False,
                              device="cpu"))


@pytest.fixture(scope="module")
def urls(services):
    jax_service, port_service = services
    with serve(jax_service, jax_make_handler(jax_service)) as a, \
            serve(port_service) as b:
        yield a, b


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_response_bytes_equal_the_jax_service(urls, name):
    path, payload = PAYLOADS[name]
    want, got = (post(url, payload, path).read() for url in urls)
    assert got == want
    if path == "/generate_batch":
        files = json.loads(got)["files"]
        assert len(files) == 3
        assert all(base64.b64decode(f)[:4] == b"MThd" for f in files)
    else:
        assert got[:4] == b"MThd"


def _drain(service, pending_cls, specs):
    """Queue one request per (genre, bars, seed, temperature) and run
    scheduler passes until all are done; returns (results, passes)."""
    reqs = [pending_cls(service.resolve_mixture({"genre": g}), bars, seed,
                        temp) for g, bars, seed, temp in specs]
    with service._pending_lock:
        service._pending.extend(reqs)
    passes = 0
    while not all(r.done.is_set() for r in reqs):
        with service._lock:
            service._run_pending_locked()
        passes += 1
    assert all(r.error is None for r in reqs)
    return [r.result for r in reqs], passes


@pytest.mark.parametrize("specs,passes", [
    ([(0, 1, 11, 1.0), (1, 2, 12, 0.8), (2, 3, 13, 1.2), (0, 4, 14, 1.0)],
     1),
    ([(2, 24, 51, 1.0)], 3),
], ids=["coalesced_mixed_bars", "time_sliced_24_bars"])
def test_scheduled_bytes_equal_the_jax_service(services, specs, passes):
    """Four mixed-bars requests coalesced into one device call, and one
    24-bar request run as a job of three 8-bar slices: each piece's bytes
    equal the JAX service's for the same queue."""
    jax_service, port_service = services
    want, _ = _drain(jax_service, JaxPending, specs)
    calls = port_service.device_calls
    got, n = _drain(port_service, _Pending, specs)
    assert n == passes and port_service.device_calls == calls + passes
    assert got == want
