"""The frozen plain references against the port, in float32 on the CPU at
tiny widths (this test imports both; the reference imports no program)."""

import torch

from benchmark.reference import tan
from benchmark.reference.common import Precision, draw_weights

from . import tiny

F32 = Precision("f32")


def _tan_model(cfg, weights, head=True):
    from temporalalignnet_torch.core.config import ModelConfig
    from temporalalignnet_torch.models.net import TANWithText

    mcfg = ModelConfig(width=cfg["width"], heads=cfg["heads"],
                       num_encoder_layers=cfg["num_encoder_layers"],
                       num_joint_layers=cfg["num_joint_layers"],
                       video_embed_dim=cfg["video_embed_dim"],
                       num_pos_embeds=cfg["num_pos_embeds"], use_alignability_head=head)
    model = TANWithText(mcfg, vocab_size=cfg["vocab_size"])
    model.load_state_dict(weights, strict=True)
    return model


def test_tan_eval_forward_equals_the_port():
    torch.manual_seed(0)
    cfg = tiny.config("tan.infer_b512")
    w = draw_weights(tan.param_shapes(cfg), tan.init_rule(cfg), 3, "cpu")
    model = _tan_model(cfg, w).eval()
    video = torch.randn(3, 16, cfg["video_embed_dim"])
    ids = torch.randint(1, cfg["vocab_size"], (3, 4, 8))
    ids[:, :, 5:] = 0
    with torch.no_grad():
        port = model.text_visual_sims(video, model.encode_text(ids, (ids != 0).int()))
        ref = tan.eval_sims(w, cfg, video, ids, F32)
    assert set(port) == set(ref)
    for k in ref:
        torch.testing.assert_close(port[k], ref[k], rtol=2e-5, atol=2e-5)


def test_tan_stage1_loss_and_gradients_equal_the_port():
    from temporalalignnet_torch.core.config import LossConfig
    from temporalalignnet_torch.losses.tan_loss import get_loss

    cfg = tiny.config("tan.stage1_graph")
    w = draw_weights(tan.param_shapes(cfg), tan.init_rule(cfg), 4, "cpu")
    model = _tan_model(cfg, w).train()
    from benchmark.traffic import make_pool

    batch = make_pool(tiny.workload("tan.stage1_graph")["traffic"], cfg["vocab_size"], 9, "cpu")[0]
    starts = (3, 0, 5)
    out = model(batch["video"], batch["input_ids"].long(),
                video_padding_mask=batch["video_padding_mask"],
                lang_padding_mask=batch["text_padding_mask"], pos_starts=starts)
    loss, _ = get_loss(out, batch, LossConfig(use_alignability_head=True))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [dict(model.named_parameters())[n] for n in names],
                                allow_unused=True)
    ref_w = {n: t.clone().requires_grad_(n in names) for n, t in w.items()}
    ref_loss = tan.train_loss(ref_w, cfg, batch, starts, F32)
    ref_grads = torch.autograd.grad(ref_loss, [ref_w[n] for n in names], allow_unused=True)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-5)
    for n, a, b in zip(names, grads, ref_grads):
        if a is None or b is None:
            assert a is None and b is None, n
            continue
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6, msg=n)


def test_group_gradient_reads_what_adamw_was_fed():
    from benchmark.drivers.common import first_moments, group_gradient

    gen = torch.Generator().manual_seed(2)
    w = torch.nn.Parameter(torch.randn(3, 4, generator=gen))
    opt = torch.optim.AdamW([w], lr=1e-3)
    grads = [torch.randn(3, 4, generator=gen) for _ in range(5)]
    moments = []
    for g in grads:
        w.grad = g.clone()
        opt.step()
        moments.append(first_moments(opt, {"w": w}, ["w"]))
    first = group_gradient({"w": torch.zeros(3, 4)}, moments[0], 1)["w"]
    assert abs(first - float(grads[0].norm())) < 1e-5 * first
    fed = sum(0.9 ** (2 - j) * grads[2 + j].double() for j in range(3))
    group = group_gradient(moments[1], moments[4], 3)["w"]
    assert abs(group - float(fed.norm())) < 1e-5 * group
