from okvis2_torch.config.parameters import ViParameters, read_config_file

__all__ = ["ViParameters", "read_config_file"]
