from repro_torch.models.zoo import EntryPoint, Model, build_model

__all__ = ["Model", "EntryPoint", "build_model"]
