"""Models of the port (hivemind_tpu/models/): the ALBERT masked-LM flagship and the
decoder-only causal LM."""

from hivemind_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForMaskedLM,
    AlbertLayer,
    make_mlm_loss_fn,
    make_synthetic_mlm_batch,
    make_train_step,
    mlm_loss,
)
from hivemind_tpu_torch.models.causal_lm import (
    CausalLM,
    CausalLMConfig,
    causal_lm_loss,
    make_synthetic_lm_batch,
)
from hivemind_tpu_torch.models.causal_lm import make_train_step as make_causal_train_step
