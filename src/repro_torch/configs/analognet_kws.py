"""AnalogNet-KWS: the paper's own keyword-spotting model (Sec. 4.1)."""

from repro_torch.models.analognet import CNNConfig, analognet_kws_config


def config() -> CNNConfig:
    return analognet_kws_config()
