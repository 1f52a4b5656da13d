"""Speech-quality metrics (composite, STOI, PESQ) and spectrum-batch scoring."""
