"""The paper's three applications (NSDI'19 Tables 4-6): the block
eigensolver, topic modeling and extreme multi-label ranking, built on the
port's csrmm (K2), k-means (B7) and the fused top-k (K2 + B8)."""
from .eigensolver import apply_gram, block_lanczos_svd, block_power_svd
from .topic_model import lift_topics, topic_model, topic_model_with_basis
from .xml_rank import xml_rank, xml_rank_in_mem

__all__ = ["apply_gram", "block_lanczos_svd", "block_power_svd", "lift_topics",
           "topic_model", "topic_model_with_basis", "xml_rank",
           "xml_rank_in_mem"]
