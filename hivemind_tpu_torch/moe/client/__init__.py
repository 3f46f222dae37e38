"""The expert clients: ``RemoteExpert`` and ``RemoteSequential`` (the port of
hivemind_tpu/moe/client/; the mixture-of-experts layers and beam search come with
a later slice)."""

from hivemind_tpu_torch.moe.client.expert import EXPERT_BREAKERS, RemoteExpert, RemoteExpertWorker
from hivemind_tpu_torch.moe.client.remote_sequential import RemoteSequential
