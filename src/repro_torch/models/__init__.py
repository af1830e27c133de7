from repro_torch.models import model  # noqa: F401
