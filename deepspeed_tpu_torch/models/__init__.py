from deepspeed_tpu_torch.models.bert import (  # noqa: F401
    BERT_SIZES, BertForPreTraining, BertForQuestionAnswering)
from deepspeed_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2, GPT2_SIZES, GPT2MoE)
from deepspeed_tpu_torch.models.pipeline_gpt2 import (  # noqa: F401
    GPT2Pipelined)
from deepspeed_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig)
