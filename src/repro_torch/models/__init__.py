from repro_torch.models.model_factory import Model, build_model

__all__ = ["Model", "build_model"]
