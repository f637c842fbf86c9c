from graphembedding.train.skipgram import SkipGramConfig, SkipGramTrainer

__all__ = ["SkipGramConfig", "SkipGramTrainer"]
