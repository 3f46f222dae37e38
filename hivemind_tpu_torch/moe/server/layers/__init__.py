"""Expert layer registry (the port of hivemind_tpu/moe/server/layers/).

``@register_expert_class(name, sample_input_fn)`` registers an ``nn.Module``
factory; the sample input (batch-size-agnostic) defines the expert's I/O schema."""

from hivemind_tpu_torch.moe.server.layers.common import (
    CausalTransformerExpert,
    FeedforwardExpert,
    LlamaBlockExpert,
    NopExpert,
    TransformerExpert,
    apply_rope,
    init_parameters,
    name_to_block,
    name_to_input,
    register_expert_class,
)
