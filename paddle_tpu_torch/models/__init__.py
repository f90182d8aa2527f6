"""Models of the port: GPT (`gpt`), moving weights to and from
paddle_tpu (`convert`) and token selection (`generation`)."""
from .convert import export_paddle_tpu_state_dict, load_paddle_tpu_state_dict
from .gpt import (GPT_CONFIGS, GPTConfig, GPTForPretraining,
                  GPTPretrainingCriterion, gpt_config)

__all__ = ["GPTConfig", "GPT_CONFIGS", "GPTForPretraining",
           "GPTPretrainingCriterion", "gpt_config",
           "export_paddle_tpu_state_dict", "load_paddle_tpu_state_dict"]
