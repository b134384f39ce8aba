"""repro_torch.serving — the one public serving surface of the port.

    from repro_torch import serving
    from repro_torch.models import get_model

    model = get_model(cfg)
    params = model.init(0, device="cuda")
    eng = serving.Engine(model, params, serving.ServeConfig(slots=8))
    rid = eng.submit([1, 2, 3], max_new_tokens=16)
    for res in eng.drain():
        print(res.id, res.tokens)

``generate`` / ``prefill`` are the single-request building blocks;
``prefill_reference`` is the token-by-token parity oracle.
"""
from repro_torch.serving.decode import (generate, make_serve_step,
                                        prefill, prefill_reference)
from repro_torch.serving.engine import (Engine, Request, RequestResult,
                                        ServeConfig)
from repro_torch.serving.kv_cache import PagedKVCache, PageTable, pages_for
from repro_torch.serving.sampling import SamplingParams, make_sampler

__all__ = [
    "Engine",
    "PageTable",
    "PagedKVCache",
    "Request",
    "RequestResult",
    "SamplingParams",
    "ServeConfig",
    "generate",
    "make_sampler",
    "make_serve_step",
    "pages_for",
    "prefill",
    "prefill_reference",
]
