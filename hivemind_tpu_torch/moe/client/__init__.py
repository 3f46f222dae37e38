"""The expert client: ``RemoteExpert`` (the port of hivemind_tpu/moe/client/; the
mixture-of-experts layers, beam search and ``RemoteSequential`` come with the
DHT)."""

from hivemind_tpu_torch.moe.client.expert import EXPERT_BREAKERS, RemoteExpert, RemoteExpertWorker
