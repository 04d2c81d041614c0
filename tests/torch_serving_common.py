"""What the port's serving tests share: a GenerationService at test_config()
on the CPU, a real HTTP server in front of it, and request helpers."""

import contextlib
import json
import threading
import urllib.request

import torch

from music_generator_tpu_torch.config import test_config
from music_generator_tpu_torch.models.deepj import build_model
from music_generator_tpu_torch.serving import (DeepJHTTPServer,
                                               GenerationService,
                                               make_handler)

torch.set_num_threads(2)

CFG = test_config()


def make_service(**kwargs) -> GenerationService:
    """A service on the CPU with fresh seed-0 weights, not warmed up."""
    params = build_model(CFG, "cpu", seed=0).state_dict()
    return GenerationService(config=CFG, params=params, warmup=False,
                             device="cpu", **kwargs)


@contextlib.contextmanager
def serve(service: GenerationService, handler=None):
    """Serve `service` on 127.0.0.1 (a free port) in a thread, through
    `handler` (default: make_handler(service)); yields the base URL and
    shuts the server down after."""
    httpd = DeepJHTTPServer(("127.0.0.1", 0),
                            handler or make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_port}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def post(url: str, payload: dict, path: str = "/generate"):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def solo(service: GenerationService, req) -> bytes:
    """The direct (uncoalesced) response for a queued request's fields."""
    return service.generate_batch([req.mixture], bars=req.bars,
                                  seed=req.seed,
                                  temperature=req.temperature)[0]
