"""The expert clients (the port of hivemind_tpu/moe/client/): ``RemoteExpert``,
``RemoteSequential``, the beam search over the DHT's uid grid, the batched
fan-out ``RemoteCallMany`` and the mixture-of-experts layers."""

from hivemind_tpu_torch.moe.client.beam_search import MoEBeamSearcher
from hivemind_tpu_torch.moe.client.call_many import EXPERT_BREAKERS, RemoteCallMany
from hivemind_tpu_torch.moe.client.expert import RemoteExpert, RemoteExpertWorker
from hivemind_tpu_torch.moe.client.moe import RemoteMixtureOfExperts, RemoteSwitchMixtureOfExperts
from hivemind_tpu_torch.moe.client.remote_sequential import RemoteSequential
