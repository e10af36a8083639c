"""NLP layer (reference L7: deeplearning4j-nlp — SURVEY.md §2.7): the
port's counterpart of ``deeplearning4j_tpu/nlp``, with the same exports.
The trainers and readers run on the card unless ``device="cpu"`` is
named."""

from deeplearning4j_tpu_torch.nlp.tokenization import (  # noqa: F401
    BasicLineIterator, CollectionSentenceIterator, CommonPreprocessor,
    DefaultTokenizerFactory, SentenceIterator, TokenPreProcess, Tokenizer)
from deeplearning4j_tpu_torch.nlp.word2vec import (  # noqa: F401
    VocabCache, VocabWord, Word2Vec)
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (  # noqa: F401
    LabelledDocument, ParagraphVectors)
from deeplearning4j_tpu_torch.nlp.serializer import (  # noqa: F401
    WordVectorSerializer)
from deeplearning4j_tpu_torch.nlp.glove import Glove  # noqa: F401
