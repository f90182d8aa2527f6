"""Models of the port: GPT (`gpt`), the paddle_tpu weight loader
(`convert`) and token selection (`generation`)."""
from .convert import load_paddle_tpu_state_dict
from .gpt import GPT_CONFIGS, GPTConfig, GPTForPretraining, gpt_config

__all__ = ["GPTConfig", "GPT_CONFIGS", "GPTForPretraining", "gpt_config",
           "load_paddle_tpu_state_dict"]
