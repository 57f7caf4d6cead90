from .pipeline import RatingArrivalStream, TokenPipeline
from .synthetic import netflix_like, synthetic_ratings, train_test_split

__all__ = ["RatingArrivalStream", "TokenPipeline", "netflix_like",
           "synthetic_ratings", "train_test_split"]
