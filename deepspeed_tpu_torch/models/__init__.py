from deepspeed_tpu_torch.models.bert import (  # noqa: F401
    BERT_SIZES, BertForPreTraining)
from deepspeed_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig)
