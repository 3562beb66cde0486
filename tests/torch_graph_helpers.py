"""The DiT decoder's graph path on the CPU (`models/dit_graphs.py`):
`replay_eagerly` lets it engage on any device and puts, in place of a
CUDA graph, a replay that runs the captured segment again, so its static
buffers, keys, arena and counters are exercised without a card."""

import types


def replay_eagerly(monkeypatch) -> None:
    from acestep_torch.models import dit_graphs

    def capture(self, body):
        body()
        return types.SimpleNamespace(replay=body)

    monkeypatch.setattr(dit_graphs, "engages",
                        lambda model, cfg, device: True)
    monkeypatch.setattr(dit_graphs.DecoderGraphs, "_capture", capture)
