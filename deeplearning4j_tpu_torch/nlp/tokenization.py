"""Tokenization + sentence iteration.

Copied from ``deeplearning4j_tpu/nlp/tokenization.py`` (pure Python; the
port keeps its own copy): the same tokens, preprocessing and iteration
order.

Reference capability: deeplearning4j-nlp's TokenizerFactory
(DefaultTokenizerFactory + preprocessors) and SentenceIterator impls
(BasicLineIterator, CollectionSentenceIterator) — SURVEY.md §2.7 NLP.
Host-side text processing, as in the reference."""

from __future__ import annotations

import re


class TokenPreProcess:
    def preProcess(self, token: str) -> str:
        return token


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation (reference: CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def preProcess(self, token):
        return self._PUNCT.sub("", token.lower())


class Tokenizer:
    def __init__(self, tokens):
        self._tokens = tokens

    def getTokens(self):
        return list(self._tokens)

    def countTokens(self):
        return len(self._tokens)


class DefaultTokenizerFactory:
    def __init__(self):
        self._pre: TokenPreProcess | None = None

    def setTokenPreProcessor(self, pre: TokenPreProcess):
        self._pre = pre

    def create(self, text: str) -> Tokenizer:
        toks = text.split()
        if self._pre is not None:
            toks = [self._pre.preProcess(t) for t in toks]
        return Tokenizer([t for t in toks if t])


class SentenceIterator:
    def __iter__(self):
        self.reset()
        return self._iter()

    def _iter(self):
        while self.hasNext():
            yield self.nextSentence()

    def hasNext(self):
        raise NotImplementedError

    def nextSentence(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences):
        self._sentences = list(sentences)
        self._pos = 0

    def hasNext(self):
        return self._pos < len(self._sentences)

    def nextSentence(self):
        s = self._sentences[self._pos]
        self._pos += 1
        return s

    def reset(self):
        self._pos = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference: BasicLineIterator)."""

    def __init__(self, path):
        self.path = path
        self._lines = None
        self._pos = 0

    def _ensure(self):
        if self._lines is None:
            with open(self.path) as f:
                self._lines = [line.strip() for line in f if line.strip()]

    def hasNext(self):
        self._ensure()
        return self._pos < len(self._lines)

    def nextSentence(self):
        self._ensure()
        s = self._lines[self._pos]
        self._pos += 1
        return s

    def reset(self):
        self._ensure()
        self._pos = 0
