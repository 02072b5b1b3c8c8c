"""Models of the port (counterpart of ``paddle_tpu/models``): the Llama
family and the ERNIE encoders."""

from .ernie import (ErnieConfig, ErnieForMaskedLM, ErnieForQuestionAnswering,
                    ErnieForSequenceClassification, ErnieForTokenClassification, ErnieModel)
from .llama import (DenseDecodeKV, LlamaConfig, LlamaForCausalLM, LlamaGreedyGenerator,
                    LlamaModel, decode_step, decode_weights)
from ._weights import load_reference_state_dict

__all__ = ["ErnieConfig", "ErnieForMaskedLM", "ErnieForQuestionAnswering",
           "ErnieForSequenceClassification", "ErnieForTokenClassification", "ErnieModel",
           "DenseDecodeKV", "LlamaConfig", "LlamaForCausalLM", "LlamaGreedyGenerator",
           "LlamaModel", "decode_step", "decode_weights", "load_reference_state_dict"]
