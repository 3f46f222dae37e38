"""Models of the port (hivemind_tpu/models/): the ALBERT masked-LM flagship."""

from hivemind_tpu_torch.models.albert import (
    AlbertConfig,
    AlbertForMaskedLM,
    AlbertLayer,
    make_mlm_loss_fn,
    make_synthetic_mlm_batch,
    make_train_step,
    mlm_loss,
)
