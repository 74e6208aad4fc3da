"""The compiled path on the CPU: a stand-in for the CUDA calls of the
compiled sampler and the compiled training step (``diffusesg_torch/utils/
cuda_graphs.py`` and the ``torch.cuda`` calls around it).

``install(mp)`` (a pytest ``MonkeyPatch``) makes those calls harmless and
gives a capture that keeps its body to call at each replay; a capture
itself runs nothing, as on the card.  It returns the list of captured
bodies.  ``stand_in`` is the same as a fixture; a test module imports it,
and a process of its own (a gloo rank) calls ``install`` under
``pytest.MonkeyPatch.context()``.
"""
import contextlib
import types

import pytest
import torch


class _Stream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


def install(mp) -> list:
    from diffusesg_torch.utils import cuda_graphs
    captures = []

    def capture(body, pool, stream):
        captures.append(body)
        return types.SimpleNamespace(replay=body)

    mp.setattr(cuda_graphs, "compiles", lambda compiled, device: compiled)
    mp.setattr(cuda_graphs, "capture", capture)
    mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    mp.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    mp.setattr(torch.cuda, "Stream", lambda *a, **k: _Stream())
    mp.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stream())
    mp.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    return captures


@pytest.fixture
def stand_in(monkeypatch):
    """The compiled path on the CPU (``install``); returns the captures."""
    return install(monkeypatch)
