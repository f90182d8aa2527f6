"""Models of the port: GPT (`gpt`), BERT (`bert`), ViT (`vit`),
conversion of weights to and from paddle_tpu (`convert`), token selection
(`generation`)."""
from .bert import (BERT_CONFIGS, BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel, bert_config)
from .convert import (export_paddle_tpu_state_dict, load_layer_state_dict,
                      load_paddle_tpu_state_dict)
from .gpt import (GPT_CONFIGS, GPTConfig, GPTForPretraining,
                  GPTPretrainingCriterion, gpt_config)
from .vit import (VIT_CONFIGS, ViTConfig, VisionTransformer, vit_b_16,
                  vit_config, vit_l_16)

__all__ = ["BertConfig", "BERT_CONFIGS", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "bert_config",
           "GPTConfig", "GPT_CONFIGS", "GPTForPretraining",
           "GPTPretrainingCriterion", "gpt_config",
           "ViTConfig", "VIT_CONFIGS", "VisionTransformer", "vit_config",
           "vit_b_16", "vit_l_16",
           "export_paddle_tpu_state_dict", "load_layer_state_dict",
           "load_paddle_tpu_state_dict"]
