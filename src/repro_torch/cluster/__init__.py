"""repro_torch.cluster — centroid workloads on the sparsified search
space: soft-SP-DTW barycenters, k-means, centroid models."""
from .barycenter import barycenter_loss, soft_barycenter
from .kmeans import (CentroidModel, fit_class_centroids, medoid_indices,
                     nearest_centroid, soft_kmeans)
