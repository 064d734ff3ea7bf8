from repro_torch.sampling.warp import warp_logits, warp_probs

__all__ = ["warp_logits", "warp_probs"]
