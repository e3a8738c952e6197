from deepspeed_tpu_torch.models.bert import (  # noqa: F401
    BERT_SIZES, BertForPreTraining, BertForQuestionAnswering)
from deepspeed_tpu_torch.models.gpt2 import GPT2, GPT2_SIZES  # noqa: F401
from deepspeed_tpu_torch.models.gpt2_moe import (  # noqa: F401
    GPT2MoE, GPT2MoEPipelined)
from deepspeed_tpu_torch.models.pipeline_gpt2 import (  # noqa: F401
    GPT2Pipelined)
from deepspeed_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig)
