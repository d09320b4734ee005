from seld_tpu_torch.losses.seld_loss import (  # noqa: F401
    SELDLossFn,
    aiur_loss,
    class_ce_loss,
    class_mse_loss,
    converging_localization_loss,
    make_class_weights,
)
