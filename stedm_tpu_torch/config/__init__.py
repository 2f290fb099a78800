from stedm_tpu_torch.config.compose import Config, compose, load_yaml, to_container

__all__ = ["Config", "compose", "load_yaml", "to_container"]
