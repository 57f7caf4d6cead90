from .synthetic import netflix_like, synthetic_ratings, train_test_split

__all__ = ["netflix_like", "synthetic_ratings", "train_test_split"]
