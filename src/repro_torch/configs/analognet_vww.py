"""AnalogNet-VWW: the paper's own visual-wake-words model (Sec. 4.1)."""

from repro_torch.models.analognet import CNNConfig, analognet_vww_config


def config() -> CNNConfig:
    return analognet_vww_config()
