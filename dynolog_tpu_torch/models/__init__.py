from dynolog_tpu_torch.models.transformer import (
    TransformerConfig,
    forward,
    init_params,
    loss_fn,
)

__all__ = ["TransformerConfig", "init_params", "forward", "loss_fn"]
