from seld_tpu_torch.eval.evaluate import evaluate_model  # noqa: F401
from seld_tpu_torch.eval.metrics import (  # noqa: F401
    accuracy_metrics,
    dcase2022_metrics,
    grid_to_frame_doas,
    seld_metrics,
)
