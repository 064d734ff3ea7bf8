from repro_torch.sampling.warp import sample_categorical, warp_logits, warp_probs

__all__ = ["sample_categorical", "warp_logits", "warp_probs"]
