from deeplearning4j_tpu_torch.clustering.vptree import VPTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kmeans import KMeansClustering  # noqa: F401,E501
from deeplearning4j_tpu_torch.clustering.tsne import BarnesHutTsne  # noqa: F401,E501
from deeplearning4j_tpu_torch.clustering.server import NearestNeighborsServer  # noqa: F401,E501
