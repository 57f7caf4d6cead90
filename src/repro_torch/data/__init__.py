from .pipeline import RatingArrivalStream
from .synthetic import netflix_like, synthetic_ratings, train_test_split

__all__ = ["RatingArrivalStream", "netflix_like", "synthetic_ratings",
           "train_test_split"]
