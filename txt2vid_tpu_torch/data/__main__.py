"""`python -m txt2vid_tpu_torch.data --sents S --out V`: build a vocabulary."""

from txt2vid_tpu_torch.data import build_parser, main

if __name__ == "__main__":
    main(build_parser().parse_args())
