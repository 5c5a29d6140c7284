from .codec import (TextCodec, decode_topk_probs, decode_topk_ids,
                    decode_instance_texts, GO_TOKEN, STOP_TOKEN, UNK_TOKEN)
