"""Host-side helpers of the port: logging, asyncio, time, tensor schemas, devices."""

from hivemind_tpu_torch.utils.nested import nested_compare, nested_flatten, nested_map, nested_pack
