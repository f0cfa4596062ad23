from repro_torch.serve.engine import GenerateResult, ServeEngine

__all__ = ["GenerateResult", "ServeEngine"]
