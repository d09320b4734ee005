from seld_tpu_torch.models.registry import build_model  # noqa: F401
