"""Conditional GAN facade, serving half (counterpart of
txt2vid_tpu/gan/cond_gan.py:63-80): holds the generator and the caption encoder.
The discriminators and loss assembly wait for the training slice."""


class CondGan:
    def __init__(self, gen, cond_encoder=None):
        self.gen = gen
        self.cond_encoder = cond_encoder

    def generate(self, z, cond=None, train: bool = False):
        """Run the generator; returns a LIST of scales (B, T, H, W, C)."""
        return self.gen(z, cond=cond, train=train)

    def encode(self, captions, lengths):
        """Caption encoding -> (B, cond_dim) sentence vectors (hn)."""
        return self.cond_encoder.encode(captions, lengths)[2]
